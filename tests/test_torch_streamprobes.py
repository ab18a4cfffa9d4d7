"""The stream probes and the SpMV probe modes (``probes.kstream``,
``probes.kprobe``, ``probes.chaintime``; ``gpu_kernels.stream_probe`` and
``spmv_probe``) held against the reference package's scripts, on the CPU.

* Each stream mix's plain version (CPU tensors) against
  ``scripts/kstream.py``'s ``make_stream(kind, 64, 256, 2)`` in interpret
  mode, on small integers from a seed (the i16 table negative and
  positive, so that the select matters): tolerance 0, the sums are exact.
  The k passes rewrite every tile's output block, which TPU interpret mode
  refuses as a revisit (the TPU itself does not), so these calls run in
  Pallas's generic interpret mode (``pallas_call(..., interpret=True)``).
* ``kprobe_stream`` against ``scripts/kprobe.py``'s ``_stream_kernel``
  through ``pallas_call`` with ``stream_bench``'s specs in TPU interpret
  mode (one pass, no revisit).
* ``chain_stream`` against ``make_stream("f32i32_sum", ...)``:
  ``scripts/chaintime.py``'s own kernel is nested under ``__main__`` and
  cannot be imported, and its body is the same function.
* ``spmvp_base`` against ``spmv4_variant(kell, x)`` in interpret mode on
  ``bench.synthetic_banded_csr(2048, 20, 300)`` at 128-row blocks, within
  3e-4 x max |output| (the reference's own tolerance for its kernels);
  the other three modes are the port's own definitions (the reference's
  values are artifacts of its TPU layout) and are held against a numpy
  computation of them within 1e-5 x max |output| (f32 sums of ~20 terms in
  another order).
* The byte and operation models count each mix's and mode's own work, no
  CPU call counts a launch, the solve's SpMV refuses a probe role, and
  each probe's ``run`` refuses without a card.

The scripts are loaded from this checkout's ``scripts/`` after the root
``bench`` of this checkout, so the fixed path they put on ``sys.path`` is
never searched, and ``monkeypatch`` restores ``sys.path`` afterwards.
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from meshlessmultigridpoisson_tpu.ops import ell as jell
from meshlessmultigridpoisson_tpu.ops import kernels4 as K4

from meshlessmultigridpoisson_torch.bench import synthetic_banded_csr
from meshlessmultigridpoisson_torch.ops import ell as tell
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.probes import chaintime, kprobe, kstream
from meshlessmultigridpoisson_torch.utils import profiling as pf

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, TPP, LANES = 256, 64, 128
N, KW, BAND = 2048, 20, 300
# the reference script's kind for each mix
KIND = {"f32i32": "f32i32_sum", "f32f32": "f32f32_sum", "f32": "f32_sum",
        "f32i16": "f32i16"}


def _reference_script(monkeypatch, name):
    """``scripts/<name>.py`` of this checkout, loaded from its path after
    the root ``bench`` of this checkout (the scripts import it from a path
    they put on ``sys.path``)."""
    monkeypatch.syspath_prepend(REPO)
    import bench  # noqa: F401  (the root bench of this checkout)

    key = f"scripts.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(REPO, "scripts", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def _make_stream(monkeypatch, kind, k):
    """``make_stream(kind, TPP, ROWS, k)``, its ``pallas_call`` built in
    generic interpret mode (the script imports ``pallas`` when called)."""
    make_stream = _reference_script(monkeypatch, "kstream").make_stream
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return make_stream(kind, TPP, ROWS, k)


def _tables(mix, seed=0):
    """Small integers: v in [-3, 3] f32; c of the mix's dtype in [-3, 3]."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-3, 4, (ROWS, LANES)).astype(np.float32)
    cdt = gk.STREAM_MIXES[mix][1]
    c = None if cdt is None else rng.integers(-3, 4, (ROWS, LANES)).astype(
        {torch.int32: np.int32, torch.float32: np.float32, torch.int16: np.int16}[cdt])
    return v, c


def _port(role, v, c, reps=2):
    before = dict(gk.COUNTS)
    out = gk.stream_probe(torch.from_numpy(v), None if c is None else torch.from_numpy(c),
                          role, TPP, reps).numpy()
    assert gk.COUNTS == before  # CPU tensors: the plain version, no launch
    return out


@pytest.mark.parametrize("mix", list(KIND))
def test_kstream_mix_plain_matches_make_stream(mix, monkeypatch):
    v, c = _tables(mix, seed=71)
    f, nin = _make_stream(monkeypatch, KIND[mix], 2)
    ref = np.asarray(f(*[jnp.asarray(t) for t in (v, c)[:nin]]))
    out = _port(f"kstream_{mix}", v, c)
    assert out.shape == ref.shape == (ROWS // TPP * 8, LANES)
    np.testing.assert_array_equal(out, ref)
    if mix == "f32i16":  # the select took some of row 0 and left some
        sel = np.where(c[::TPP] > 0, v[::TPP], 0)
        assert (sel != 0).any() and ((c[::TPP] <= 0) & (v[::TPP] != 0)).any()


def test_kprobe_stream_plain_matches_stream_kernel(monkeypatch):
    kern = _reference_script(monkeypatch, "kprobe")._stream_kernel
    v, c = _tables("f32i32", seed=72)
    grid = ROWS // TPP
    with pltpu.force_tpu_interpret_mode():  # read when the call is built
        f = pl.pallas_call(
            kern, out_shape=jax.ShapeDtypeStruct((grid * 8, LANES), jnp.float32),
            grid=(grid,),
            in_specs=[pl.BlockSpec((TPP, LANES), lambda i: (i, np.int32(0)))] * 2,
            out_specs=pl.BlockSpec((8, LANES), lambda i: (i, np.int32(0))))
        ref = np.asarray(jax.jit(f)(jnp.asarray(v), jnp.asarray(c)))
    np.testing.assert_array_equal(_port("kprobe_stream", v, c, reps=1), ref)


@pytest.mark.parametrize("k", [1, 3])
def test_chain_stream_plain_matches_make_stream(k, monkeypatch):
    """``scripts/chaintime.py``'s kernel is defined under ``__main__`` (not
    importable); its body is ``make_stream("f32i32_sum", ...)``'s."""
    v, c = _tables("f32i32", seed=73)
    f, _ = _make_stream(monkeypatch, "f32i32_sum", k)
    ref = np.asarray(f(jnp.asarray(v), jnp.asarray(c)))
    np.testing.assert_array_equal(_port("chain_stream", v, c, reps=k), ref)


@pytest.fixture(scope="module")
def banded():
    a = synthetic_banded_csr(N, KW, BAND, seed=0)
    x = np.random.default_rng(74).standard_normal(N).astype(np.float32)
    return a, tell.ell_from_csr(a, block_rows=128), x


def _probe_ell(et, mode):
    return gk.spmv_probe_ell(gk.device_ell(et, torch.float32, "cpu", "spmv4"), mode)


def _probe(et, role, x):
    A = _probe_ell(et, role)
    before = dict(gk.COUNTS)
    y = gk.spmv_probe(A, torch.from_numpy(x)).numpy()
    assert gk.COUNTS == before
    return A, y


def test_spmvp_base_plain_matches_spmv4_variant(banded, monkeypatch):
    spmv4_variant = _reference_script(monkeypatch, "kprobe").spmv4_variant
    a, et, x = banded
    kell = K4.prepare_kernel_ell4(jell.ell_from_csr(a, block_rows=128))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(spmv4_variant(kell, jnp.asarray(x)))
    _, out = _probe(et, "spmvp_base", x)
    assert out.shape == ref.shape == (N,)
    np.testing.assert_allclose(out, ref, rtol=0, atol=3e-4 * np.abs(ref).max())


@pytest.mark.parametrize("mode", sorted(gk.SPMV_PROBE_MODES))
def test_spmv_probe_mode_plain_matches_its_definition(banded, mode):
    """f64 numpy: per entry v * x[col] or v * col * 1e-9, then the row sum
    or, for row r, the sum of the entries k = r % 32, r % 32 + 32, ..."""
    _, et, x = banded
    vals, cols = et.vals.numpy().astype(np.float64), tell.global_cols(et).numpy()
    gather = mode in ("spmvp_base", "spmvp_noreduce")
    prod = vals * (x.astype(np.float64)[cols] if gather else cols * 1e-9)
    if mode in ("spmvp_base", "spmvp_nogather"):
        want = prod.sum(1)
    else:
        lane = np.arange(prod.shape[0]) % 32
        k = np.arange(prod.shape[1])
        want = np.where(k[None, :] % 32 == lane[:, None], prod, 0.0).sum(1)
    _, out = _probe(et, mode, x)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert np.abs(want).max() > 0


def test_probe_roles_stay_off_the_solve_path(banded):
    _, et, x = banded
    with pytest.raises(ValueError, match="unknown SpMV role"):
        gk.device_ell(et, torch.float32, "cpu", "spmvp_nogather")
    A = gk.device_ell(et, torch.float32, "cpu", "spmv6")
    with pytest.raises(ValueError, match="not an SpMV probe role"):
        gk.spmv_probe(A, torch.from_numpy(x))
    with pytest.raises(ValueError, match="not an SpMV probe role"):
        gk.spmv_probe_ell(A, "spmv6")
    v, c = _tables("f32i16")
    with pytest.raises(ValueError, match="unknown stream role"):
        gk.stream_probe(torch.from_numpy(v), torch.from_numpy(c), "f32i16", TPP)
    with pytest.raises(ValueError, match="c absent"):
        gk.stream_probe(torch.from_numpy(v), None, "kstream_f32i16", TPP)
    with pytest.raises(ValueError, match="c given"):
        gk.stream_probe(torch.from_numpy(v), torch.from_numpy(c), "kstream_f32", TPP)


@pytest.mark.parametrize("mix,per_elem", [("f32i32", 8), ("f32f32", 8), ("f32", 4),
                                          ("f32i16", 6)])
def test_stream_bytes_count_each_mix(mix, per_elem):
    v, c = (None if t is None else torch.from_numpy(t) for t in _tables(mix))
    out = ROWS // TPP * 8 * LANES * 4
    assert pf.stream_bytes(v, c, TPP) == ROWS * LANES * per_elem + out
    # the reference sizes: [2^18, 128] at 4096-row tiles, 3.35 TB/s
    big = 2 ** 18 * 128 * per_elem + 2 ** 18 // 4096 * 8 * 128 * 4
    want_us = {8: 80.2, 4: 40.1, 6: 60.2}[per_elem]
    assert big / 3.35e12 * 1e6 == pytest.approx(want_us, abs=0.05)


@pytest.mark.parametrize("mode", sorted(gk.SPMV_PROBE_MODES))
def test_spmv_probe_bytes_count_each_modes_own_work(banded, mode):
    """Values and int32 columns of the nonzeros and y; x only where the
    mode gathers it (numpy counts)."""
    _, et, x = banded
    A = _probe_ell(et, mode)
    nnz = int(np.count_nonzero(et.vals.numpy()))
    gather = mode in ("spmvp_base", "spmvp_noreduce")
    want = nnz * 8 + 4 * et.nrows_pad + (4 * et.ncols if gather else 0)
    assert pf.spmv_probe_bytes(A) == want
    assert pf.spmv_probe_flops(A) == (2 if gather else 3) * nnz
    if gather:
        assert pf.spmv_probe_bytes(A) == pf.spmv_bytes(A)


@pytest.mark.parametrize("probe", [kstream, kprobe, chaintime],
                         ids=["kstream", "kprobe", "chaintime"])
def test_probe_run_refuses_without_a_card(probe):
    with pytest.raises(SystemExit, match="card"):
        probe.run()


def test_kprobe_host_prep_is_the_reference_operator():
    """The banded operator of ``build_operator`` is the reference script's
    (``synthetic_banded_csr(n, 70, 512)``) in the port's 128-row ELL."""
    ell = kprobe.build_operator(n=4096)
    a = synthetic_banded_csr(4096, kprobe.K, kprobe.BAND, 0)
    y = gk.ell_spmv_plain(ell.vals, tell.global_cols(ell),
                          torch.ones(4096, dtype=torch.float64))
    np.testing.assert_allclose(y.numpy()[:4096], a @ np.ones(4096), rtol=1e-12)
    assert ell.block_rows == 128 and ell.width <= kprobe.K


SASS = """
        Function : _ZN50_GLOBAL__N__x13stream_kernelILi3EEEvPKfPKviiiPf
        /*0100*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0110*/                   LDG.E.64 R8, desc[UR4][R6.64] ;
        /*0120*/                   LDG.E.128 R12, desc[UR4][R2.64+0x4000] ;
        /*0130*/                   LDG.E.64 R10, desc[UR4][R6.64+0x2000] ;
        Function : _ZN50_GLOBAL__N__x13stream_kernelILi2EEEvPKfPKviiiPf
        /*0100*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
"""


@pytest.mark.parametrize("drop", [0, 1], ids=["live", "dropped"])
def test_sassloads_counts_loads_per_instance(monkeypatch, drop):
    """The f32i16 instance's loads are live while it holds a 64-bit load
    (i16) for every 128-bit one (f32); a dropped i16 load fails the rule."""
    from types import SimpleNamespace

    from meshlessmultigridpoisson_torch.probes import sassloads

    text = SASS.replace("LDG.E.64 R10", "MOV R10", drop)
    monkeypatch.setattr(sassloads, "_tool", lambda name: name)
    monkeypatch.setattr(sassloads.subprocess, "run",
                        lambda *a, **k: SimpleNamespace(stdout=text))
    loads = sassloads.library_loads("lib.so")
    assert loads["_ZN50_GLOBAL__N__x13stream_kernelILi3EEEvPKfPKviiiPf"] == {
        "LDG.E.128": 2, "LDG.E.64": 2 - drop}
    assert sum(loads["_ZN50_GLOBAL__N__x13stream_kernelILi2EEEvPKfPKviiiPf"].values()) == 1
    assert sassloads.i16_loads_live(loads) is (drop == 0)


@pytest.mark.parametrize("case", ["same", "differs", "missing"])
def test_sassloads_compare_matches_instances_with_a_zero_mode(monkeypatch, case):
    """``compare`` pairs each instance of the old source with the new
    source's instance of the same template arguments plus trailing zeros
    (a compile-time mode whose 0 is the production code) and reports the
    first instruction where they differ."""
    from meshlessmultigridpoisson_torch.probes import sassloads

    sig = "void (anonymous namespace)::chain_kernel<float, __nv_bfloat16, (int)0>(Args<float>)"
    assert sassloads._args(sig, "chain_kernel") == ["float", "__nv_bfloat16", "(int)0"]
    base = ["LDG.E R2, desc[UR4][R4.64]", "FFMA R0, R2, R3, R0", "EXIT"]
    new = {("float", "float", "(int)0"): list(base), ("float", "float", "(int)1"): ["EXIT"]}
    if case == "differs":
        new[("float", "float", "(int)0")][1] = "FMUL R0, R2, R3"
    elif case == "missing":
        del new[("float", "float", "(int)0")]
    monkeypatch.setattr(sassloads, "kernel_sass",
                        lambda src, kernel: {("float", "float"): base} if src == "old.cu" else new)
    res = sassloads.compare("old.cu", "new.cu", "chain_kernel")
    row = res["instances"]["<float, float>"]
    assert res["same"] is (case == "same") and row["same"] is (case == "same")
    if case == "differs":
        assert row["first_diff"] == 1 and row["new_insn"] == "FMUL R0, R2, R3"
    if case == "missing":
        assert row["new"] is None


def test_device_ms_refuses_the_cpu():
    with pytest.raises(ValueError, match="card"):
        pf.device_ms(lambda v: v * 2, torch.zeros(4))
