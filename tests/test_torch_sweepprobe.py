"""The sweep probe's modes (``probes.ksweepprobe``, ``gpu_kernels.sweep_probe``)
held against the reference package's ``scripts/ksweepprobe.py``, on the CPU.

* ``probe_base``, ``probe_nodot`` and ``probe_nogather`` (their plain
  versions: CPU tensors) against ``make_sweep_variant(mode)`` in interpret
  mode, on ``bench.synthetic_banded_csr(2048, 20, 300)`` at 128-row blocks
  (16 blocks, two of the reference's 8-block programs), omega 1.4 with
  every row smoothed, a Lagrange column and x_lag 0.3;
* ``probe_hoist`` against a numpy computation of its definition (the
  reference's hoist reads the patch list of each program's first block
  for all eight, a layout artifact no other layout reproduces);
* the probe roles never run through ``block_oneshot_sweep`` (no solve
  reaches them), and ``ksweepprobe.run`` refuses without a card.

Both packages take the reference's K (``ops/kernels4.build_oneshot_K``),
which differs from the port's on this operator: see the fixture.
Tolerance: 3e-4 x max |output|, the reference's own for its kernels;
``probe_nodot``'s output grows to ~1e3 x its input in one sweep (x += b -
A x with diagonal 21).
"""

import dataclasses
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from meshlessmultigridpoisson_tpu.ops import ell as jell
from meshlessmultigridpoisson_tpu.ops import kernels4 as K4
from meshlessmultigridpoisson_tpu.ops import kernels6 as K6

from meshlessmultigridpoisson_torch.bench import build_operator, synthetic_banded_csr
from meshlessmultigridpoisson_torch.ops import ell as tell
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.probes import ksweepprobe

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 3e-4
N, KW, BAND = 2048, 20, 300
NB = N // 128
OMEGA = 1.4


@pytest.fixture(scope="module")
def problem():
    a = synthetic_banded_csr(N, KW, BAND, seed=0)
    ej, et = jell.ell_from_csr(a, block_rows=128), tell.ell_from_csr(a, block_rows=128)
    rng = np.random.default_rng(81)
    inp = dict(x=rng.standard_normal(N).astype(np.float32),
               b=rng.standard_normal(N).astype(np.float32),
               lagc=(0.01 * rng.standard_normal(N)).astype(np.float32),
               xl=np.float32(0.3))
    # the reference's K in both packages: on this operator its fancy-index
    # accumulation drops entries that an ELL padding slot of the same row
    # shares a column with (the port's build_oneshot_K keeps them)
    kT = K4.build_oneshot_K(ej, np.full(N, OMEGA), np.ones(N))
    assert np.abs(gk.build_oneshot_K(et, np.full(N, OMEGA), np.ones(N)) - kT).max() > 1e-3
    return ej, et, kT, inp


def _sweep(et, kT, inp, role):
    return gk.BlockSweep(A=gk.device_ell(et, torch.float32, "cpu", "spmv6"),
                         kT=torch.from_numpy(kT).float(),
                         lagc=torch.from_numpy(inp["lagc"]),
                         order=torch.arange(NB, dtype=torch.int32), phase_ptr=(0, NB),
                         serial=True, role=role)


def _run(sw, inp):
    return gk.sweep_probe(sw, torch.from_numpy(inp["x"].copy()), torch.tensor(inp["xl"]),
                          torch.from_numpy(inp["b"])).numpy()


def _reference_script(monkeypatch, name):
    """``scripts/<name>.py`` of this checkout, loaded from its path.  The
    reference scripts put a fixed checkout path on ``sys.path`` and import
    the root ``bench`` and ``scripts.kcache`` when imported: both are loaded
    from this checkout first, so that path is never searched, and
    ``monkeypatch`` restores ``sys.path`` after the test."""
    monkeypatch.syspath_prepend(REPO)
    import bench  # noqa: F401  (the root bench of this checkout)

    for mod in ("kcache", name):
        key = f"scripts.{mod}"
        if key not in sys.modules:
            spec = importlib.util.spec_from_file_location(
                key, os.path.join(REPO, "scripts", f"{mod}.py"))
            module = importlib.util.module_from_spec(spec)
            sys.modules[key] = module
            spec.loader.exec_module(module)
    return sys.modules[f"scripts.{name}"]


def _close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=0, atol=F32_TOL * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["base", "nodot", "nogather"])
def test_probe_mode_plain_matches_make_sweep_variant(problem, mode, monkeypatch):
    make_sweep_variant = _reference_script(monkeypatch, "ksweepprobe").make_sweep_variant

    ej, et, kT, p = problem
    kell = K6.prepare_kernel_ell6(ej)
    kv = K6.pack_oneshot_K6(kell, kT, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = make_sweep_variant(mode)(
            kell, kv, jnp.asarray(p["x"].reshape(NB, 128)), p["xl"],
            jnp.asarray(p["b"].reshape(NB, 128)), jnp.asarray(p["lagc"].reshape(NB, 128)))
    ref = np.asarray(ref).reshape(-1)
    before = dict(gk.COUNTS)
    out = _run(_sweep(et, kT, p, f"probe_{mode}"), p)
    assert gk.COUNTS == before  # CPU tensors: the plain version, no launch
    _close(out, ref)
    assert np.abs(out - p["x"]).max() > 0.02 * np.abs(p["x"]).max()  # it moved


def test_probe_hoist_plain_matches_its_definition(problem):
    """Per group of 8 consecutive blocks: every row's t from x as the group
    began, then x_blk += K_blk t_blk; f64 numpy."""
    _, et, kT, p = problem
    out = _run(_sweep(et, kT, p, "probe_hoist"), p)
    vals, cols = et.vals.numpy(), tell.global_cols(et).numpy()
    x = p["x"].astype(np.float64)
    for g in range(0, NB, gk.PROBE_GROUP):
        rows = np.arange(g * 128, (g + gk.PROBE_GROUP) * 128)
        t = p["b"][rows] - (vals[rows] * x[cols[rows]]).sum(1) - p["lagc"][rows] * p["xl"]
        for j in range(gk.PROBE_GROUP):
            blk = slice(j * 128, (j + 1) * 128)
            x[rows[blk]] += t[blk] @ kT[g + j]  # kT is K transposed
    _close(out, x)
    base = _run(_sweep(et, kT, p, "probe_base"), p)
    assert np.abs(base - x).max() > 30 * F32_TOL * np.abs(x).max()  # stale reads


def test_probe_roles_stay_off_the_solve_path_and_need_a_card(problem):
    _, et, kT, p = problem
    sw = _sweep(et, kT, p, "probe_nodot")
    with pytest.raises(ValueError, match="timing probe"):
        gk.block_oneshot_sweep(sw, torch.from_numpy(p["x"].copy()), torch.tensor(0.0),
                               torch.from_numpy(p["b"]))
    with pytest.raises(ValueError, match="not a probe role"):
        gk.sweep_probe(_sweep(et, kT, p, "sweep6"), torch.zeros(N), 0.0, torch.zeros(N))
    colored = dataclasses.replace(sw, serial=False, phase_ptr=(0, NB // 2, NB))
    with pytest.raises(ValueError, match="storage-order"):
        gk.sweep_probe(colored, torch.zeros(N), 0.0, torch.zeros(N))
    op = build_operator(n=N, k=KW, band=BAND)
    nodot = ksweepprobe.probe_sweep(op, "probe_nodot", "cpu")
    assert torch.equal(nodot.A.vals * ksweepprobe.NODOT_SCALE,
                       ksweepprobe.probe_sweep(op, "probe_base", "cpu").A.vals)
    with pytest.raises(SystemExit, match="card"):
        ksweepprobe.run(iters=1, op=op)


@pytest.mark.parametrize("mode", sorted(gk.PROBE_MODES))
def test_probe_bound_counts_each_modes_own_work(problem, mode):
    """``probe_nogather`` reads no A (values and columns), ``probe_nodot``
    no K; base and hoist as the production sweep (numpy counts)."""
    from meshlessmultigridpoisson_torch.utils import profiling as pf

    _, et, kT, p = problem
    sw = _sweep(et, kT, p, mode)
    a_nz, k_nz = int(np.count_nonzero(et.vals.numpy())), int(np.count_nonzero(kT))
    vecs = 4 * N + 4 * NB + 3 * 4 * N  # lag_col, block order, x in and out, b
    a, k = a_nz * 8, k_nz * 4
    want = {"probe_nodot": (a, 2 * a_nz), "probe_nogather": (k, 2 * k_nz)}.get(
        mode, (a + k, 2 * (a_nz + k_nz)))
    assert (pf.probe_bytes(sw), pf.probe_flops(sw)) == (want[0] + vecs, want[1])
    if mode in ("probe_base", "probe_hoist"):
        assert (pf.probe_bytes(sw), pf.probe_flops(sw)) == (pf.sweep_bytes(sw),
                                                            pf.sweep_flops(sw))
