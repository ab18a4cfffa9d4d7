"""The colored smoother's read-set tables (``gpu_kernels.block_read_tables``)
on the CPU: each block's sorted distinct x rows and each ELL entry's place
among them, on the card tests' kd-tile fixture (``test_torch_cuda._knn_ell``)
and on random tables.  Exact: these are integer tables."""

import numpy as np
import pytest
import torch

from meshlessmultigridpoisson_torch.ops import ell as tell
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from test_torch_cuda import _knn_ell


def _table(case):
    """(global int32 columns [nb * 128, width], nb)."""
    if case == "kdtile":
        et = _knn_ell(28)
        return tell.global_cols(et).numpy().astype(np.int32), et.nrows_pad // 128
    rng = np.random.default_rng(5)
    nb, width = 12, 9
    # "random": 64-bit sort keys (columns past 2^21); "dense": many repeats
    n = 1 << 27 if case == "random" else 300
    return rng.integers(0, n, (nb * 128, width)).astype(np.int32), nb


@pytest.mark.parametrize("case", ["kdtile", "random", "dense"])
def test_read_tables_name_every_entry(case):
    """rows[b][lcols[row]] == gcols[row] (so x[rows[b]][lcols[row]] ==
    x[gcols[row]] for any x) for every entry, padding entries included; each list sorted and distinct to nr[b], its padding
    the first row; nr[b] at most the rows of the block's x patches; the
    width a multiple of 4; the counts as the tables give them."""
    gcols, nb = _table(case)
    rd = gk.block_read_tables(gcols, nb, "cpu")
    rows, nr, lcols = rd.rows.numpy(), rd.nr.numpy(), rd.lcols.numpy()
    assert rows.dtype == np.int32 and nr.dtype == np.int32 and lcols.dtype == np.int16
    assert rows.shape == (nb, rows.shape[1]) and lcols.shape == gcols.shape
    assert rows.shape[1] % 4 == 0 and rows.shape[1] - 4 < nr.max() <= rows.shape[1]
    blk = np.arange(nb * 128) // 128
    assert np.array_equal(rows[blk[:, None], lcols.astype(np.int64)], gcols)
    patches = gk.block_patches(gcols, nb)
    for b in range(nb):
        r = rows[b, :nr[b]]
        assert np.array_equal(r, np.unique(gcols[b * 128:(b + 1) * 128]))
        assert (rows[b, nr[b]:] == r[0]).all()
        assert nr[b] <= np.unique(patches[b]).size * 128
        assert lcols[b * 128:(b + 1) * 128].max() < nr[b]
    npat = np.array([np.unique(p).size for p in patches]) * 128
    assert rd.counts == {"staged_x_mean": float(nr.mean()), "staged_x_max": int(nr.max()),
                         "patch_rows_mean": float(npat.mean()),
                         "patch_rows_max": int(npat.max())}


def test_read_tables_refuse_past_int16():
    """A block of 32,768 distinct columns cannot be indexed by int16 places:
    it raises; one of 32,767 is taken."""
    over = np.arange(128 * 256, dtype=np.int32).reshape(128, 256)
    with pytest.raises(ValueError, match="32768 x values"):
        gk.block_read_tables(over, 1, "cpu")
    at = over.copy()
    at[-1, -1] = at[-1, -2]
    rd = gk.block_read_tables(at, 1, "cpu")
    assert int(rd.nr[0]) == gk.READ_MAX and rd.rows.shape[1] == 32768


def test_read_set_shared_bytes():
    """``colored_smooth``'s layout: each ELL buffer carries the read list
    (int32) after the values and int16 columns, and the staged x values
    take ``nrx`` of the vectors' dtype."""
    f32, f64 = torch.float32, torch.float64
    al = gk._al128
    assert gk.smooth_smem_bytes(2, 2, 25, f32, f32, cbytes=2, nrx=1124) == (
        128 + 2 * 65536 + 2 * al(128 * 25 * 6 + 4 * 1124) + al(4 * 1124)
        + 512 + 2048 + 128)
    assert gk.smooth_smem_bytes(2, 1, 70, f64, f64, cbytes=2, nrx=1076) == (
        128 + 2 * 131072 + al(128 * 70 * 10 + 4 * 1076) + al(8 * 1076)
        + 1024 + 4096 + 256)
