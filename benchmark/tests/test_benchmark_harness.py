"""CPU tests of the benchmark harness (``benchmark/``).

    python -m pytest benchmark/tests -q

The cells run here at small sizes through the kernels' plain versions;
what needs the card is in ``test_benchmark_cuda.py``.
"""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.drivers.rhs_stream import point_order
from benchmark.inputs.clouds import make_clouds
from benchmark.inputs.fields import SourceStream
from benchmark.run import execute
from benchmark.spec import ROOT, Spec
from benchmark.tests.tiny import tiny_root

BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_benchmark_json_parses_and_names_are_plain():
    spec = Spec()
    d = spec.data
    assert set(d) == TOP_KEYS
    names = [c["name"] for c in d["configs"]] + [k for c in d["configs"] for k in c["reduced"]]
    names += [x for w in d["workloads"] for x in (w["name"], w["config"], w["traffic"])]
    names += [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    for name in names:
        assert NAME.fullmatch(name), name
    metrics = d["end_to_end"] + d["per_layer"]
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in d["configs"]:
        assert set(c) == CONFIG_KEYS and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in d["workloads"]:
        assert set(w) == CELL_KEYS and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS and m["source"] in ("host_clock",
                                                                    "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
    assert len({m["name"] for m in metrics}) == len(metrics)
    for w in d["workloads"]:  # setup_s, another end-to-end metric, a per-layer one
        e2e = {m["name"] for m in spec.metrics(w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics(w["name"], True)
    for m in metrics:  # every metric has its reader
        assert callable(spec.reader(m["name"]).read)
    for w in d["workloads"]:
        assert spec.driver(spec.traffic(w["traffic"])["driver"]).run


def test_new_cell_config_mix_and_metric_are_new_files_only(tmp_path):
    root = tiny_root(tmp_path)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(bench, "configs", "fresh.json"), "w") as f:
        json.dump(dict(cfg, sizes=[170, 700]), f)
    with open(os.path.join(bench, "traffic", "dirichlet-rhs-stream.json")) as f:
        mix = json.load(f)
    with open(os.path.join(bench, "traffic", "fresh-mix.json"), "w") as f:
        json.dump(dict(mix, tol=1e-10), f)
    with open(os.path.join(bench, "metrics", "solve.fresh_count.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx['solves'])\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        d = json.load(f)
    d["configs"].append(dict(d["configs"][0], name="fresh", file="benchmark/configs/fresh.json"))
    d["workloads"].append({"name": "fresh.cell", "config": "fresh", "traffic": "fresh-mix",
                           "chips": 1, "why": "test"})
    d["per_layer"].append({"name": "solve.fresh_count", "unit": "solves", "better": "higher",
                           "source": "program_counter", "layer": "outer solve",
                           "moves": "solve_s", "workloads": ["fresh.cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(d, f)

    spec = Spec(root)
    cell = spec.cell("fresh.cell")
    assert spec.config(cell["config"])["sizes"] == [170, 700]
    assert spec.traffic(cell["traffic"])["tol"] == 1e-10
    names = [m["name"] for m in spec.metrics("fresh.cell", True)]
    assert names == ["solve.fresh_count"]
    assert spec.reader("solve.fresh_count").read({"solves": [1, 2, 3]}) == 3
    assert {m["name"] for m in spec.metrics("fresh.cell", False)} == {"setup_s", "solve_s"}
    assert spec.driver(spec.traffic(cell["traffic"])["driver"]).run


def test_a_run_prints_five_keys_and_its_checks_last(tmp_path):
    spec = Spec(tiny_root(tmp_path))
    line = execute(spec, "tiny.dirichlet", 2**31 + 12345, 3.0, False, torch.device("cpu"))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"setup_s", "solve_s", "solve_p90_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    res = line["checks"]["residual_max"]
    assert 0 < res["value"] <= res["limit"] == 1e-8
    json.loads(json.dumps(line))


def test_without_a_card_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "square_hole-150k.dirichlet",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["tiny.dirichlet", "tiny.neumann", "tiny3d.dirichlet"])
def test_reference_agrees_with_the_ports_host_solve(tmp_path, cell):
    """The port's host f64 BiCGStab on the benchmark's inputs, judged by the
    reference: its residual there is the port's own operator's, to rounding."""
    from meshlessmultigridpoisson_torch.mg.krylov import solve_bicgstab
    from meshlessmultigridpoisson_torch.mg.vcycle import init_state
    from meshlessmultigridpoisson_torch.models.poisson import fine_rhs
    from meshlessmultigridpoisson_torch.utils.metrics import bordered_residual

    spec = Spec(tiny_root(tmp_path))
    w = spec.cell(cell)
    config, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    d = spec.driver(mix["driver"])
    inp = d.make_inputs(config, mix, 7)
    prog = d.Program(config, inp.neumann, inp.clouds, torch.device("cpu"))
    perm = point_order(inp.clouds[-1].points, prog.fine_points)
    src = inp.stream.source(inp.stream.wavenumber(0))
    hier = prog.host_hierarchy
    fine = hier.levels[-1]
    b = fine_rhs(fine, src[perm], inp.neumann)
    state = init_state(hier, torch.zeros(fine.n, dtype=torch.float64))
    x0 = torch.where(fine.dirichlet_mask > 0, fine.dirichlet_values, 0.0)  # pinned, as
    state = state.replace_level(len(hier.levels) - 1, b=b, x=x0)  # make_poisson_problem does
    state, _, _ = solve_bicgstab(hier, state, tol=1e-9, max_iters=300)
    own = bordered_residual(fine, b, 0.0, state.x[-1], state.x_lag[-1])
    x = torch.empty(perm.shape[0], dtype=torch.float64)
    x[torch.as_tensor(perm)] = fine.to_logical(state.x[-1])
    ref = d.reference(inp, config, torch.device("cpu"))
    got = ref.relative_residual(x, float(state.x_lag[-1]), src)
    assert own < 1e-8
    assert abs(got - own) <= 1e-4 * own + 1e-13


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(top: str) -> list[str]:
    return [os.path.join(dp, f) for dp, _, fs in os.walk(top) for f in fs if f.endswith(".py")]


def test_no_jax_and_a_reference_free_of_the_port():
    files = _sources(BENCH)
    assert files
    for path in files:
        names = _imports(path)
        assert not names & {"jax", "jaxlib", "flax", "meshlessmultigridpoisson_tpu"}, path
    for path in _sources(os.path.join(BENCH, "reference")):
        assert "meshlessmultigridpoisson_torch" not in _imports(path), path
    tests = os.path.join(BENCH, "tests")
    for path in [p for p in files if not p.startswith(tests)] + [
            os.path.join(BENCH, "inputs", "fastgeom.cpp")]:
        with open(path) as f:
            text = f.read()
        assert "BENCH_r" not in text and "bench.py" not in text, path


def test_config_points_are_what_the_frozen_generator_gives():
    spec = Spec()
    for c in spec.data["configs"]:
        cfg = spec.config(c["name"])
        got = [cl.n for cl in make_clouds(cfg["geometry"], cfg["sizes"], cfg["cloud_seed"])]
        assert got == cfg["points"], c["name"]


def test_sources_depend_on_seed_and_index_alone():
    pts = make_clouds("square_with_circle", [640], 0)[0].points
    mix = {"boundary": "dirichlet", "wavenumbers": [1, 2, 3, 4]}
    a, b = SourceStream(pts, 2**33 + 5, mix), SourceStream(pts, 2**33 + 5, mix)
    seq = [a.wavenumber(i) for i in range(40)]
    assert seq == [b.wavenumber(i) for i in range(40)]
    for j in range(10):  # every four solves take each wavenumber once
        assert sorted(seq[4 * j:4 * j + 4]) == [1, 2, 3, 4]
    assert seq != [SourceStream(pts, 6, mix).wavenumber(i) for i in range(40)]
    assert np.array_equal(a.source(3), SourceStream(pts, 6, mix).source(3))


@pytest.mark.parametrize("geometry,size", [("square_with_circle", 640), ("box3d", 500)])
@pytest.mark.parametrize("boundary", ["dirichlet", "neumann"])
def test_sources_are_the_reference_manufactured_ones(geometry, size, boundary):
    """The stream's source of wavenumber k is the port's manufactured source
    with k1 = k2 = k, as ``make_poisson_problem`` poses it."""
    from meshlessmultigridpoisson_torch.models import poisson

    pts = make_clouds(geometry, [size], 0)[0].points
    s = SourceStream(pts, 1, {"boundary": boundary, "wavenumbers": [1, 2, 3, 4]})
    port = poisson.source_box3d if geometry == "box3d" else poisson.source_square
    for k in (1, 2, 3, 4):
        want = port(pts, boundary == "neumann", k, k)
        np.testing.assert_allclose(s.source(k), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_point_order_places_a_permutation_and_refuses_others():
    rng = np.random.default_rng(0)
    ours = rng.random((50, 2))
    p = rng.permutation(50)
    assert np.array_equal(point_order(ours, ours[p]), p)
    other = ours[p].copy()
    other[3, 0] += 1e-12
    assert point_order(ours, other) is None
