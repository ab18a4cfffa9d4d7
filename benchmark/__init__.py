"""The benchmark of the PyTorch and CUDA port (``meshlessmultigridpoisson_torch``).

``python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``;
the cells, configurations, mixes and metrics are in ``BENCHMARK.json`` and
the files it names (``spec.py``).  Nothing here imports JAX or the JAX
package; ``reference/`` imports nothing of the port either.
"""
