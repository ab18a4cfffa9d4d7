"""``ell_spmv``'s row lengths and column formats (ops/gpu_kernels.py), and
the storage-order chain's wrapper, on the CPU.

The CUDA kernels have no interpret mode: on the CPU ``ell_spmv`` runs its
plain version, which reads each row only to ``DeviceEll.lens`` (one past
its last nonzero) through the table's global columns (int32, or u16
offsets from a per-128-row-block base).  On the cut that
``tests/test_torch_neumann.py`` builds (``SLICE``: 600 / 2500 / 5000
points at deg 4, kd-tile order, 512-row assembly blocks), without and with
Neumann boundaries, built once by the reference package and carried over
as numpy arrays (``interop``):

* ``lens`` is one past the last nonzero of every row of every level matrix
  and transfer, and an interior zero weight does not cut a row short;
* the plain version that reads to ``lens`` equals ``ell_spmv_plain`` (every
  stored entry) and the reference's SpMV on the same inputs
  (``ops/ell.spmv``; ``kernels6.spmv_tpu6`` and ``kernels8.spmv_tpu8`` in
  TPU interpret mode, as the reference's tests run them): rtol 2e-4 of max
  |y| in f32 (the reference's kernels sum in another order, with
  HIGHEST-precision dots), 1e-12 in f64 (the same products, summed in
  another order);
* the u16 offsets round-trip to the global columns, the repack takes them
  for the tables no sweep reads, and a table with a block spanning more
  than 65,535 columns keeps int32 by the rule.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_neumann import SLICE

from meshlessmultigridpoisson_tpu.models import poisson as jpoisson
from meshlessmultigridpoisson_tpu.ops import ell as jell
from meshlessmultigridpoisson_tpu.ops import kernels6 as K6
from meshlessmultigridpoisson_tpu.ops import kernels8 as K8
from meshlessmultigridpoisson_tpu.ops.kernels4 import build_oneshot_K as build_K_ref

from meshlessmultigridpoisson_torch import interop
from meshlessmultigridpoisson_torch.mg import gpu_backend
from meshlessmultigridpoisson_torch.ops import ell as tell
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.utils import profiling as pf

# one intra-op thread per worker process (the workers share the host's cores)
torch.set_num_threads(1)

TOL = {torch.float32: 2e-4, torch.float64: 1e-12}


@functools.lru_cache(maxsize=2)
def _build(neumann: bool):
    """(reference Hierarchy, port Hierarchy) of the slice's cut."""
    prob = jpoisson.make_poisson_problem(
        SLICE["geom"], sizes=SLICE["sizes"], poly_deg=SLICE["deg"],
        neumann=neumann, ordering=SLICE["ordering"],
        block_rows=SLICE["block_rows"])
    hj = prob.hierarchy
    tree = dataclasses.asdict(jax.tree_util.tree_map(np.asarray, hj))
    return hj, interop.hierarchy_from_numpy(tree)


@pytest.fixture(scope="module", params=[False, True], ids=["dirichlet", "neumann"])
def hier(request):
    return _build(request.param)


def _tables(hj, ht):
    """[(name, reference EllMatrix, port EllMatrix)]: every level matrix,
    restriction and prolongation."""
    out = [(f"level {i}", lj.A, lt.A) for i, (lj, lt) in enumerate(zip(hj.levels, ht.levels))]
    for kind in ("restrict", "prolong"):
        out += [(f"{kind} {i}", ej, et)
                for i, (ej, et) in enumerate(zip(getattr(hj, kind), getattr(ht, kind)))]
    return out


def _x(n, dtype, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(dtype)


def test_lens_is_one_past_the_last_nonzero(hier):
    hj, ht = hier
    short = 0
    for name, _, et in _tables(hj, ht):
        A = gk.device_ell(et, torch.float32, "cpu", "spmv6")
        v = A.vals.numpy()
        nz = v != 0
        want = np.where(nz.any(1), v.shape[1] - np.argmax(nz[:, ::-1], axis=1), 0)
        np.testing.assert_array_equal(A.lens.numpy(), want, err_msg=name)
        short += int((A.lens < A.width).sum())
    assert short > 0  # some rows stop short of the table's width
    # an interior weight that is exactly zero does not cut its row short
    et = ht.levels[-1].A
    r = int(np.argmax(gk.row_lens(et.vals).numpy()))
    vals = et.vals.clone()
    vals[r, 1] = 0.0
    A = gk.device_ell(dataclasses.replace(et, vals=vals), torch.float32, "cpu", "spmv8")
    assert int(A.lens[r]) == int(gk.row_lens(et.vals)[r]) > 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_lens_plain_matches_plain_and_reference_spmv(hier, dtype):
    hj, ht = hier
    for i, (name, ej, et) in enumerate(_tables(hj, ht)):
        x = _x(et.ncols, dtype, i)
        for u16 in (False, True):
            A = gk.device_ell(et, dtype, "cpu", "spmv6", u16=u16)
            y = gk.ell_spmv(A, x)
            full = gk.ell_spmv_plain(A.vals, tell.global_cols(et), x)
            scale = float(full.abs().max())
            np.testing.assert_allclose(y.numpy(), full.numpy(), rtol=0,
                                       atol=TOL[dtype] * scale, err_msg=name)
        if dtype == torch.float32:
            yref = np.asarray(jell.spmv(ej, jnp.asarray(x.numpy())))
            np.testing.assert_allclose(y.numpy()[: yref.size], yref, rtol=0,
                                       atol=TOL[dtype] * scale, err_msg=name)


@pytest.mark.parametrize("kernel", ["spmv_tpu8", "spmv_tpu6"])
def test_lens_plain_matches_tpu_kernels_in_interpret_mode(kernel):
    """On the Neumann cut (rows of mixed lengths; interpret mode is slow, so
    the coarsest level, 1,024 rows): its matvec against ``spmv_tpu8`` over
    its colored tables and against ``spmv_tpu6`` (the reference's coarsest
    matvec and transfer kernel), f32, through u16 columns."""
    hj, ht = _build(True)
    ej, et = hj.levels[0].A, ht.levels[0].A
    assert int((gk.row_lens(et.vals) < et.width).sum()) > 0
    if kernel == "spmv_tpu8":
        nb = et.nrows_pad // gk.LANES
        table = K8.prepare_colored_sweep(
            K6.prepare_kernel_ell6(ej, max_segments=1),
            build_K_ref(ej, np.ones(et.nrows_pad), np.ones(et.nrows_pad)),
            np.zeros((nb, gk.LANES), np.float32), max_expand=4.0, min_blocks=2)
        run = K8.spmv_tpu8
    else:
        table, run = K6.prepare_kernel_ell6(ej), K6.spmv_tpu6
    x = _x(et.ncols, torch.float32, 1)
    with pltpu.force_tpu_interpret_mode():
        yref = np.asarray(run(table, jnp.asarray(x.numpy())))
    y = gk.ell_spmv(gk.device_ell(et, torch.float32, "cpu", "spmv8", u16=True), x)
    n = min(y.numel(), yref.size)
    np.testing.assert_allclose(y.numpy()[:n], yref[:n], rtol=0,
                               atol=TOL[torch.float32] * float(np.abs(yref).max()),
                               err_msg=kernel)


def test_u16_offsets_round_trip_and_the_repack_takes_them(hier):
    hj, ht = hier
    for name, _, et in _tables(hj, ht):
        A = gk.device_ell(et, torch.float32, "cpu", "spmv6", u16=True)
        assert A.col_format == "u16", name
        assert A.cols.dtype == torch.int16 and A.col_base.shape == (et.nrows_pad // 128,)
        np.testing.assert_array_equal(A.global_cols().numpy(),
                                      tell.global_cols(et).numpy().astype(np.int64))
        x = _x(et.ncols, torch.float32, 3)
        i32 = gk.device_ell(et, torch.float32, "cpu", "spmv6")
        assert i32.col_format == "i32" and i32.cols.dtype == torch.int32
        assert torch.equal(gk.ell_spmv(A, x), gk.ell_spmv(i32, x))
        assert torch.equal(A.lens, i32.lens)
        # the parent design's table: int32 columns again
        assert torch.equal(gk.rowwarp_ell(A).cols, i32.cols)
    g = gpu_backend.gpu_hierarchy(ht, "cpu")
    op64 = gpu_backend.gpu_level_from_operator(ht.levels[-1], "cpu", torch.float64,
                                               sweep=False)
    fmt = gpu_backend.col_formats(g, op64)
    nl = len(ht.levels)
    assert fmt == {"levels": ["i32"] * nl, "restrict": ["u16"] * (nl - 1),
                   "prolong": ["u16"] * (nl - 1), "outer_f64": "u16"}


def _wide_table(span: int, nrows: int = 256) -> tell.EllMatrix:
    """Two entries a row; row 5 reads column ``span``, every other row
    column 0 and its own: block 0 spans ``span`` columns."""
    import scipy.sparse as sp

    n = max(span + 1, nrows)
    rows = np.repeat(np.arange(nrows), 2)
    cols = np.stack([np.zeros(nrows, int), np.arange(nrows)], 1)
    cols[5, 1] = span
    vals = np.random.default_rng(0).standard_normal((nrows, 2))
    a = sp.coo_matrix((vals.ravel(), (rows, cols.ravel())), shape=(nrows, n)).tocsr()
    return tell.ell_from_csr(a, block_rows=128, ncols=n)


@pytest.mark.parametrize("span,fmt", [(65_535, "u16"), (65_536, "i32")])
def test_a_block_past_the_u16_span_keeps_int32(span, fmt):
    et = _wide_table(span)
    assert gk.u16_span(tell.global_cols(et)) == span
    A = gk.device_ell(et, torch.float64, "cpu", "spmv6", u16=True)
    assert A.col_format == fmt
    x = _x(et.ncols, torch.float64, 4)
    want = gk.ell_spmv_plain(A.vals, tell.global_cols(et), x)
    np.testing.assert_allclose(gk.ell_spmv(A, x).numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))
    assert A.global_cols().max() == span


def test_spmv_bytes_count_the_column_format(hier):
    _, ht = hier
    et = ht.restrict[-1]
    i32 = gk.device_ell(et, torch.float32, "cpu", "spmv6")
    u16 = gk.device_ell(et, torch.float32, "cpu", "spmv6", u16=True)
    nnz = int((i32.vals != 0).sum())
    vecs = (et.ncols + et.nrows_pad) * 4
    assert pf.spmv_bytes(i32) == nnz * 8 + vecs
    assert pf.spmv_bytes(u16) == nnz * 6 + 4 * (et.nrows_pad // 128) + vecs


@pytest.mark.parametrize("role", ["sweep6", "sweep5"])
def test_storage_chain_on_the_cpu_is_the_plain_sweep(hier, role):
    """The ``sweep6`` level the repack gives a storage-order level that
    ``coarse_smooth`` cannot hold, and ``ktime``'s ``sweep5``, run
    ``storage_chain``; on CPU tensors its plain version, the same as
    ``block_oneshot_sweep``; a colored sweep or another role is refused."""
    _, ht = hier
    lv = gpu_backend.gpu_level_from_operator(ht.levels[-1], "cpu", torch.float64,
                                             sweep_order="exact")
    sw = dataclasses.replace(lv.sweep, role=role)
    x, b = _x(lv.n_pad, torch.float64, 5), _x(lv.n_pad, torch.float64, 6)
    xl = torch.tensor(0.3, dtype=torch.float64)
    out = gk.storage_chain(sw, x.clone(), xl, b)
    assert torch.equal(out, gk.block_oneshot_sweep_plain(sw, x.clone(), xl, b))
    assert torch.equal(gk.block_oneshot_sweep(sw, x.clone(), xl, b), out)
    for bad in (dataclasses.replace(sw, role="sweep6_chain"),
                dataclasses.replace(sw, serial=False)):
        with pytest.raises(ValueError, match="storage_chain walks"):
            gk.storage_chain(bad, x.clone(), xl, b)


def test_blockgraph_longest_path(hier):
    """``probes.blockgraph``: the storage-order dependency graph's longest
    path counts one for blocks that share no nonzero, the whole chain for
    a band that ties each block to the next, and lies between on a level."""
    from meshlessmultigridpoisson_torch.probes import blockgraph

    n, w = 256, 2
    own = np.stack([np.arange(n), np.arange(n)], 1)
    assert blockgraph.longest_path(own, np.ones((n, w), bool), 8) == (1, 32)
    band = np.stack([np.arange(n), np.minimum(np.arange(n) + 1, n - 1)], 1)
    assert blockgraph.longest_path(band, np.ones((n, w), bool), 8) == (32, 32)
    _, ht = hier
    st = blockgraph.level_stats(ht.levels[-1].A)
    assert 1 < st["longest_path_128"] <= st["blocks_128"]
    assert st["longest_path_128"] < st["longest_path_8"] <= st["tiles_8"]
    assert 0 < st["fill"] <= 1 and st["nnz_per_row_median"] <= st["width"]
