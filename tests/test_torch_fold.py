"""The fold of ``compact_rows`` into its neighbouring launches, on the CPU.

The V-cycle's own re-solves of the fine level now ride in the fine smoother
call (``smooth(..., resolve_first=, resolve_last=)``: the re-solve, then the
Dirichlet pin, before the first sweep; one more re-solve after the last),
and the compatible PPE matvec's tail after its SpMVs is one ``ppe_tail``
call.  On CPU tensors every wrapper runs its plain version, so here:

* the smoother call with both re-solves against the unfused composition
  (``bound_eval_neumann``, ``apply_dirichlet``, ``smooth``,
  ``bound_eval_neumann``), bit for bit in f64, on the Neumann slice's
  colored fine level (``sweep8``), its coarsest (``sweep7``) and its v2
  fine level (``smooth_loop``), each as it is (no Dirichlet row) and with
  Dirichlet rows that the boundary rows read, pinned on entry or not (the
  unpinned case shows that the pin's place matters: pinning first gives
  other bits);
* one V-cycle and ``krylov._precond`` on the Neumann two-level cut
  600/2500 against the reference's ``v_cycle`` and ``krylov._precond`` on
  the same operators (its host path, the storage-order GS that its
  ``sor_sweep_tpu7`` computes; both of the port's levels are ``sweep7``):
  f64 within 1e-11 of max |x|, f32 within 1e-4;
* the f32 compatible matvec (``_mv32``: four SpMVs, then ``ppe_tail``)
  against the reference's ``fracstep_tpu._mv32`` in interpret mode on the
  NS problem 170/600, deg 4, within the f32 kernel budget (2e-4 of max |y|);
* the compact tables' ``lens`` against the host rows.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from meshlessmultigridpoisson_torch import interop
from meshlessmultigridpoisson_torch.mg import gpu_backend, krylov, mixed
from meshlessmultigridpoisson_torch.mg.vcycle import MGState, v_cycle
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.ops import smoothers as sm
from meshlessmultigridpoisson_torch.utils import profiling as pf
from test_torch_native import ensure_native_geometry

torch.set_num_threads(1)

SLICE = dict(geomtype="square_with_circle", poly_deg=4, ordering="kdtile",
             block_rows=512, neumann=True)


def _numpy_tree(obj):
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, obj))


@pytest.fixture(scope="module")
def slice_levels():
    """The port's Neumann slice 600/2500/5000 (host levels)."""
    from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return make_poisson_problem(sizes=[600, 2500, 5000], **SLICE).hierarchy.levels


def _level(slice_levels, kind):
    op = slice_levels[-1 if kind != "coarsest" else 0]
    gl = gpu_backend.gpu_level_from_operator(op, "cpu", torch.float64,
                                             use_v6=False if kind == "v2" else None)
    return op, gl


def _read_rows(gl):
    """Rows (no boundary target) that the boundary rows read: each row's
    first such nonzero's column."""
    C = gl.bound
    targets = set(C.rows[: C.nrows].tolist())
    out = set()
    for i in range(C.nrows):
        for v, c in zip(C.vals[i].tolist(), C.cols[i].tolist()):
            if v != 0 and c not in targets:
                out.add(c)
                break
    return torch.tensor(sorted(out))


@pytest.mark.parametrize("dirichlet", ["none", "pinned", "unpinned"])
@pytest.mark.parametrize("kind,role", [("colored", "sweep8"), ("coarsest", "sweep7"),
                                       ("v2", "sweep2")])
def test_fused_resolves_are_the_unfused_composition(slice_levels, kind, role, dirichlet):
    op, gl = _level(slice_levels, kind)
    assert gl.sweep.role == role and gl.bound.nrows > 0 and gl.has_lagrange
    rng = np.random.default_rng(61)
    x = torch.from_numpy(rng.standard_normal(gl.n_pad))
    b = torch.from_numpy(rng.standard_normal(gl.n_pad))
    xl, bl = torch.tensor(0.3, dtype=torch.float64), torch.tensor(-0.2, dtype=torch.float64)
    if dirichlet != "none":
        rows = _read_rows(gl)
        assert rows.numel() > 10
        mask = torch.zeros(gl.n_pad, dtype=torch.float64)
        mask[rows] = 1.0
        vals = torch.from_numpy(rng.standard_normal(gl.n_pad))
        gl = dataclasses.replace(gl, dirichlet_mask=mask, dirichlet_values=vals)
        if dirichlet == "pinned":
            x = torch.where(mask > 0, vals, x)
    fused, fused_l = gpu_backend.smooth(gl, x, xl, b, bl, resolve_first=True,
                                        resolve_last=True)
    y = sm.apply_dirichlet(gl, gpu_backend.bound_eval_neumann(gl, x, b), coarse=False)
    y, yl = gpu_backend.smooth(gl, y, xl, b, bl)
    y = gpu_backend.bound_eval_neumann(gl, y, b)
    assert torch.equal(fused, y) and torch.equal(fused_l, yl)
    assert not torch.equal(fused, gpu_backend.smooth(gl, x, xl, b, bl)[0])
    if dirichlet == "unpinned":  # the pin's place matters here
        w = gpu_backend.bound_eval_neumann(gl, sm.apply_dirichlet(gl, x, coarse=False), b)
        w = gpu_backend.bound_eval_neumann(gl, gpu_backend.smooth(gl, w, xl, b, bl)[0], b)
        assert not torch.equal(fused, w)
    # the host path takes the same arguments
    if kind == "coarsest" and dirichlet == "none":
        hx, hl = sm.smooth(op, x, xl, b, bl, resolve_first=True, resolve_last=True)
        hy = sm.apply_dirichlet(op, sm.bound_eval_neumann(op, x, b), coarse=False)
        hy, hyl = sm.smooth(op, hy, xl, b, bl)
        assert torch.equal(hx, sm.bound_eval_neumann(op, hy, b)) and torch.equal(hl, hyl)


@pytest.fixture(scope="module")
def two_level():
    """(reference defect hierarchy, port host hierarchy) of the Neumann
    two-level cut 600/2500, the operators shared through ``interop``."""
    from meshlessmultigridpoisson_tpu.models.poisson import make_poisson_problem as jmake

    ensure_native_geometry()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pj = jmake(SLICE["geomtype"], sizes=[600, 2500], poly_deg=SLICE["poly_deg"],
                   ordering=SLICE["ordering"], block_rows=SLICE["block_rows"], neumann=True)
    return pj.hierarchy, interop.hierarchy_from_numpy(_numpy_tree(pj.hierarchy))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11), (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_vcycle_and_precond_match_reference(two_level, dtype, tol):
    from meshlessmultigridpoisson_tpu.mg import krylov as jkrylov
    from meshlessmultigridpoisson_tpu.mg import mixed as jmixed
    from meshlessmultigridpoisson_tpu.mg import vcycle as jvcycle

    hj, ht = two_level
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    hdj = jmixed.defect_hierarchy(jax.tree_util.tree_map(
        lambda a: a.astype(jdt) if a.dtype == jnp.float64 else a, hj))
    hd = mixed.defect_hierarchy(gpu_backend.gpu_hierarchy(ht, "cpu", dtype))
    assert [lv.sweep.role for lv in hd.levels] == ["sweep7", "sweep7"]
    assert hd.levels[-1].bound.nrows > 0
    n = hd.levels[-1].n_pad
    rng = np.random.default_rng(62)
    v, x = (rng.standard_normal(n).astype(np.dtype(jdt)) for _ in range(2))
    vl = np.asarray(0.05, dtype=jdt)

    def held(port, ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(np.asarray(port), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())

    zj, zlj = jkrylov._precond(hdj, jnp.asarray(v), jnp.asarray(vl))
    z, zl = krylov._precond(hd, torch.from_numpy(v), torch.from_numpy(vl))
    held(z, zj)
    held(zl, zlj)
    # one V-cycle from a non-zero fine x (the start's re-solve moves it)
    zeros = [np.zeros(lv.n_pad, dtype=jdt) for lv in hd.levels]
    xs, bs = (zeros[0], x), (zeros[0], v)
    sj, rj = jvcycle.v_cycle(hdj, jvcycle.MGState(
        x=tuple(map(jnp.asarray, xs)), x_lag=(jnp.asarray(vl),) * 2,
        b=tuple(map(jnp.asarray, bs)), b_lag=(jnp.zeros((), jdt), jnp.asarray(vl))))
    st, rt = v_cycle(hd, MGState(
        x=tuple(torch.from_numpy(a.copy()) for a in xs),
        x_lag=(torch.from_numpy(vl),) * 2, b=tuple(torch.from_numpy(a) for a in bs),
        b_lag=(torch.zeros((), dtype=dtype), torch.from_numpy(vl))))
    held(st.x[-1], sj.x[-1])
    held(st.x_lag[-1], sj.x_lag[-1])
    assert abs(float(rt) - float(rj)) <= tol * abs(float(rj))


def test_ppe_tail_plain_matches_reference_mv32():
    from meshlessmultigridpoisson_tpu.config import FracStepConfig as JConfig
    from meshlessmultigridpoisson_tpu.models import fracstep as jfs
    from meshlessmultigridpoisson_tpu.models import fracstep_tpu as ft

    from meshlessmultigridpoisson_torch.models import fracstep_gpu as fg
    from test_torch_fracstep import _problem_tree

    ensure_native_geometry()
    jprob = jfs.build_fracstep_problem(sizes=[170, 600], poly_deg=4, config=JConfig())
    gfs = fg.build_gpu_fracstep(interop.fracstep_problem_from_numpy(_problem_tree(jprob)),
                                "cpu")
    T = gfs.ppe32
    assert T.C.role == "ppe2" and T.C.vals is gfs.hd.levels[-1].bound.vals
    rows = T.C.rows[: T.C.nrows].long()
    assert torch.equal(T.slot[rows].long(), torch.arange(T.C.nrows))
    assert int((T.slot >= 0).sum()) == T.C.nrows
    rng = np.random.default_rng(63)
    x = rng.standard_normal(gfs.n_pad).astype(np.float32)
    xl = np.float32(0.3)
    with pltpu.force_tpu_interpret_mode():
        yj, ylj = (np.asarray(a) for a in ft._mv32(ft.build_tpu_fracstep(jprob))(
            jnp.asarray(x), jnp.asarray(xl)))
    before = dict(gk.COUNTS)
    y, yl = fg._mv32(gfs)(torch.from_numpy(x), torch.tensor(xl))
    assert gk.COUNTS == before  # plain versions: nothing launched
    np.testing.assert_allclose(y.numpy(), yj, rtol=0, atol=2e-4 * np.abs(yj).max())
    assert abs(float(yl) - float(ylj)) <= 2e-4 * abs(float(ylj))
    # the tail alone against its parent composition, on the matvec's inputs
    xt = torch.from_numpy(x)
    p = gk.ell_spmv(gfs.dx32, gk.ell_spmv(gfs.dx32, xt))
    q = gk.ell_spmv(gfs.dy32, gk.ell_spmv(gfs.dy32, xt))
    assert torch.equal(gk.ppe_tail(T, p, q, xt, torch.tensor(xl)), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_compact_tables_lens_match_host_rows(slice_levels, dtype):
    for op in slice_levels:
        for table, role in ((op.bound, "bound2"), (op.cond, "push2")):
            C = gk.device_compact(table, dtype, "cpu", role)
            vals = table.ell.vals.numpy()
            nz = vals != 0
            want = np.where(nz.any(axis=1), vals.shape[1] - np.argmax(nz[:, ::-1], axis=1), 0)
            np.testing.assert_array_equal(C.lens.numpy(), want)
            assert C.lens.dtype == torch.int32
            assert (C.lens[C.rows >= C.n_pad] == 0).all()  # sentinel slots: nothing
            if table.nrows:
                assert 0 < pf.compact_fill(C) <= 1
