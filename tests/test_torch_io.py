"""The port's bundles, checkpoints and txt vectors (``io/bundle.py``), held
against the reference package's ``io`` on the CPU.

* A reference hierarchy carried across by ``interop`` goes through
  ``save_bundle`` / ``load_bundle`` with its clouds, and every leaf comes
  back bit-equal; the file is a plain ``np.load(allow_pickle=False)`` npz.
* The reference's resume test (``tests/test_io.py``): 5 V-cycles, a
  checkpoint, 5 more from the loaded state and the loaded bundle, equal
  to the run that never left memory (atol 1e-13, as there) and to the
  reference's own 10 cycles (1e-10 of max |x|); a ``FracStepState`` comes
  back bit-equal and as its own type.
* Stamps: a bundle stamped for other arguments is refused, and so is one
  without a stamp (the reference only warns).
* The txt vectors read back in either package.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from meshlessmultigridpoisson_tpu.io.bundle import read_vector_txt as jread
from meshlessmultigridpoisson_tpu.io.bundle import write_vector_txt as jwrite
from meshlessmultigridpoisson_tpu.mg.vcycle import run_v_cycles as jrun
from meshlessmultigridpoisson_tpu.models.poisson import make_poisson_problem as jmake

from meshlessmultigridpoisson_torch import interop, io
from meshlessmultigridpoisson_torch.geometry.pointclouds import PointCloud
from meshlessmultigridpoisson_torch.io import bundle
from meshlessmultigridpoisson_torch.mg.vcycle import run_v_cycles as trun
from meshlessmultigridpoisson_torch.models.fracstep import FracStepState

torch.set_num_threads(1)

STAMP = dict(geom="square", sizes=[200, 700], deg=3, k=1, neumann=False, seed=0, msh=[],
             ordering="rcm", block_rows=256)


def _numpy_tree(obj):
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, obj))


def _leaves(t, path=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, t


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k, v in la.items():
        if isinstance(v, np.ndarray):
            assert lb[k].dtype == v.dtype and lb[k].shape == v.shape, k
            assert np.array_equal(lb[k], v), k
        else:
            assert lb[k] == v and type(lb[k]) is type(v), k


@pytest.fixture(scope="module")
def reference():
    # the reference's tests/test_io.py problem
    return jmake("square", sizes=[200, 700], poly_deg=3, k1=1)


def _clouds(pj):
    return [PointCloud(points=np.asarray(c.points), boundaries=[np.asarray(b) for b in
                                                                c.boundaries],
                       normals=np.asarray(c.normals), geomtype=c.geomtype)
            for c in pj.clouds]


def test_bundle_round_trip_is_bit_equal_and_plain_npz(reference, tmp_path):
    want = _numpy_tree(reference.hierarchy)
    hier = interop.hierarchy_from_numpy(want)
    path = io.save_bundle(str(tmp_path / "bundle"), hier, _clouds(reference),
                          build_config=STAMP)
    assert path.endswith("bundle.npz")
    with np.load(path, allow_pickle=False) as data:
        assert bundle.MANIFEST in data.files and len(data.files) > 50
        assert all(data[k].dtype != object for k in data.files)
    hier2, clouds2 = io.load_bundle(path, STAMP)
    _assert_trees_equal(interop.hierarchy_to_numpy(hier), interop.hierarchy_to_numpy(hier2))
    # and against the reference's own leaves
    got = dict(_leaves(interop.hierarchy_to_numpy(hier2)))
    for k, v in _leaves(want):
        assert np.array_equal(np.asarray(got[k]), np.asarray(v)), k
    for c, cj in zip(clouds2, reference.clouds):
        assert np.array_equal(c.points, cj.points) and np.array_equal(c.normals, cj.normals)
        assert all(np.array_equal(b, bj) for b, bj in zip(c.boundaries, cj.boundaries))
        assert c.geomtype == cj.geomtype


def test_mg_state_resume_matches_reference(reference, tmp_path):
    hier = interop.hierarchy_from_numpy(_numpy_tree(reference.hierarchy))
    state0 = interop.state_from_numpy(_numpy_tree(reference.state0))
    bpath = io.save_bundle(str(tmp_path / "b.npz"), hier, build_config=STAMP)
    hier2, clouds = io.load_bundle(bpath, STAMP)
    assert clouds is None
    state, _ = trun(hier, state0, 5)
    spath = io.save_state(str(tmp_path / "state.npz"), state)
    state2 = io.load_state(spath)
    assert type(state2) is type(state)
    _assert_trees_equal(interop.state_to_numpy(state), interop.state_to_numpy(state2))
    a, _ = trun(hier, state, 5)
    b, _ = trun(hier2, state2, 5)
    np.testing.assert_allclose(b.x[-1].numpy(), a.x[-1].numpy(), rtol=0, atol=1e-13)
    ref, _ = jrun(reference.hierarchy, reference.state0, 10)
    xr = np.asarray(ref.x[-1])
    assert np.abs(b.x[-1].numpy() - xr).max() <= 1e-10 * np.abs(xr).max()


def test_fracstep_state_round_trip(reference, tmp_path):
    rng = np.random.default_rng(3)
    mg = interop.state_from_numpy(_numpy_tree(reference.state0))
    n = mg.x[-1].shape[0]
    state = FracStepState(mg=mg, **{k: torch.from_numpy(rng.standard_normal(n)) for k in
                                    ("u", "v", "u_old", "v_old", "u_hat", "v_hat")})
    path = io.save_state(str(tmp_path / "fs"), state)
    back = io.load_state(path)
    assert isinstance(back, FracStepState)
    _assert_trees_equal(interop.fracstep_state_to_numpy(state),
                        interop.fracstep_state_to_numpy(back))


def test_stamps_refuse_other_arguments_and_no_stamp(reference, tmp_path):
    hier = interop.hierarchy_from_numpy(_numpy_tree(reference.hierarchy))
    path = io.save_bundle(str(tmp_path / "b"), hier, build_config=STAMP)
    with pytest.raises(io.StampError, match="different problem"):
        io.load_bundle(path, dict(STAMP, deg=4))
    unstamped = bundle.save_tree(str(tmp_path / "u"), "bundle",
                                 bundle.load_tree(path, "bundle"))
    with pytest.raises(io.StampError, match="no build_config stamp"):
        io.load_bundle(unstamped, STAMP)
    with pytest.raises(ValueError, match="not a 'poisson_problem'"):
        io.load_problem(path, STAMP)
    with pytest.raises(ValueError, match="not a solver state"):
        io.load_state(path)


def test_txt_vectors_read_back_in_either_package(tmp_path):
    v = np.linspace(-1, 1, 17) ** 3
    io.write_vector_txt(v, str(tmp_path / "t.txt"))
    jwrite(v, str(tmp_path / "j.txt"))
    assert np.array_equal(jread(str(tmp_path / "t.txt")), v)
    assert np.array_equal(io.read_vector_txt(str(tmp_path / "j.txt")), v)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
