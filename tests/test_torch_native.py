"""Both packages' native geometry libraries, and the helper that loads them
before a test builds a point cloud through both packages.

Each package builds ``fastgeom.cpp`` with g++ at first use and falls back
to a pure-Python path when the library does not load.  The two paths
sample different clouds (square_with_circle at 600/2500/5000: 632 / 2,432
/ 4,721 points natively, 629 / 2,390 / 4,637 through the Python path), so
a test that compares the packages' sizes or solutions must run both on the
native path.  The reference package builds its library in place
(``g++ -o csrc/libfastgeom.so``): a second test process can load the
half-written file, fail, and keep the Python path for the rest of its
life.  ``ensure_native_geometry`` retries the load until the library is
whole (bounded) and fails with the real cause otherwise.
"""

import os
import time

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from meshlessmultigridpoisson_tpu.geometry import native as jnative
from meshlessmultigridpoisson_tpu.geometry import pointclouds as jclouds

from meshlessmultigridpoisson_torch.geometry import native as tnative
from meshlessmultigridpoisson_torch.geometry import pointclouds as tclouds

# One BLAS / OpenMP thread a test process.  The suite runs in several
# worker processes, each of which imports every test module while it
# collects; with the BLAS's default of a thread per core in each, the
# workers oversubscribe the host and its spinning threads stall them
# (on an 8-core host, a batched 128 x 128 inverse that takes 0.7 s alone
# ran for over 40 min beside six such processes).  The processes the tests
# spawn inherit the variables.
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("OMP_NUM_THREADS", "1")
BLAS_LIMIT = threadpool_limits(limits=1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_LIB = os.path.join(REPO, "csrc", "libfastgeom.so")
LOAD_TIMEOUT_S = 60.0
LOAD_RETRY_S = 0.5


def ensure_native_geometry(timeout_s: float = LOAD_TIMEOUT_S) -> None:
    """Load the reference's and the port's native geometry library.  Where
    the reference's load failed while its library file exists (another
    process may be writing it), forget the failure and retry every
    ``LOAD_RETRY_S`` until ``timeout_s``; then require both loaded."""
    deadline = time.monotonic() + timeout_s
    while (jnative._build_and_load() is None and os.path.exists(REFERENCE_LIB)
           and time.monotonic() < deadline):
        time.sleep(LOAD_RETRY_S)
        jnative._tried = False
    tnative._build_and_load()
    assert jnative._lib is not None, (
        f"the reference's native geometry library ({REFERENCE_LIB}) did not load: its "
        "clouds would come from the Python path, with other sizes than the port's")
    assert tnative._lib is not None, "the port's native geometry library did not load"


def test_a_failed_reference_load_is_retried(monkeypatch):
    """A process whose first load failed (``_tried`` set, no library) gets
    the library on the retry."""
    ensure_native_geometry()
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    assert jnative._build_and_load() is None
    ensure_native_geometry()
    assert jnative._lib is not None and tnative._lib is not None


@pytest.mark.parametrize("n", [600, 2500])
def test_native_clouds_match_between_packages(n):
    """The same native Poisson-disk cloud in both packages: the sizes the
    CLI parity tests compare."""
    ensure_native_geometry()
    cj = jclouds.square_with_circle_cloud(n, seed=0)
    ct = tclouds.square_with_circle_cloud(n, seed=0)
    assert ct.n == cj.n == {600: 632, 2500: 2432}[n]
    np.testing.assert_array_equal(np.asarray(ct.points), np.asarray(cj.points))
