"""PyTorch port, the native host cell list (``native/cellist.py``, a copy of
the JAX package's C++ list built with g++ into ``_build/``).

Its edges, sorted by (i, j, S), equal array for array those of the numpy
linked-cell list (``cell_list_numpy``, the plain version), the JAX
package's native list and the brute force on a periodic FCC box of 500
atoms, the 10,976-atom bench box, a triclinic cell, an open 55-atom
cluster and an empty input; on mixed periodicity (which the numpy list
hands to the brute force) and on a periodic cell under 3 cutoffs (which
``cell_list_neighbor_list`` hands to the brute force) they equal the brute
force.  A failed build raises ``NativeBuildError`` with the compiler's
message; the library is named by the source's hash, and concurrent
builds leave one library.
"""
import multiprocessing as mp
import os
import shutil

import numpy as np
import pytest
import torch

from schnetpack_tpu.native import cellist as jcellist
from schnetpack_tpu_torch.native import cellist
from schnetpack_tpu_torch.transform.neighborlist import (
    cell_list_neighbor_list, cell_list_numpy, neighbor_list,
)
from torch_port_cases import fcc_argon

CUTOFF = 5.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def assert_edges_equal(got, want, name=""):
    assert len(got) == len(want) == 3
    for a, b, k in zip(got, want, ("idx_i", "idx_j", "S")):
        assert a.dtype == np.int64, (name, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {k}")


def triclinic(seed=3):
    rng = np.random.RandomState(seed)
    cell = np.array([[21.0, 0.0, 0.0], [5.1, 20.2, 0.0], [-4.1, 3.4, 22.9]])
    return rng.rand(400, 3) @ cell, cell


def cluster(n=55, seed=1):
    """An open cluster of ``n`` atoms at least 2.2 A apart."""
    rng = np.random.RandomState(seed)
    R = [np.zeros(3)]
    while len(R) < n:
        r = rng.uniform(-7.0, 7.0, 3)
        if np.linalg.norm(np.asarray(R) - r, axis=1).min() >= 2.2:
            R.append(r)
    return np.asarray(R)


def _case(name):
    if name == "fcc500":
        R, cell = fcc_argon(5, jitter=0.3, seed=2)
        return R, cell, np.ones(3, bool)
    if name == "bench":
        R, cell = fcc_argon(14)
        return R, cell, np.ones(3, bool)
    if name == "triclinic":
        return (*triclinic(), np.ones(3, bool))
    if name == "cluster":
        return cluster(), None, None
    if name == "cluster_zero_cell":
        return cluster(seed=4), np.zeros((3, 3)), np.zeros(3, bool)
    if name == "empty":
        return np.zeros((0, 3)), np.eye(3) * 20.0, np.ones(3, bool)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["fcc500", "bench", "triclinic", "cluster",
                                  "cluster_zero_cell", "empty"])
def test_native_list_matches_numpy_and_jax(name):
    R, cell, pbc = _case(name)
    got = cell_list_neighbor_list(R, CUTOFF + 0.6, cell, pbc)
    assert_edges_equal(got, cellist.neighbor_list(R, CUTOFF + 0.6, cell, pbc),
                       name)
    assert_edges_equal(got, cell_list_numpy(R, CUTOFF + 0.6, cell, pbc), name)
    if len(R):
        assert len(got[0]) > 0
        assert_edges_equal(
            got, jcellist.neighbor_list(R, CUTOFF + 0.6, cell, pbc), name)
    if len(R) <= 600:
        assert_edges_equal(got, neighbor_list(R, CUTOFF + 0.6, cell, pbc),
                           name)


@pytest.mark.parametrize("pbc", [(True, True, False), (False, True, False)])
def test_mixed_periodicity_matches_brute_force(pbc):
    """The C++ list bins the open axes of a mixed cell (the numpy list
    takes the brute force there): the same edges as the brute force."""
    rng = np.random.RandomState(6)
    cell = np.diag([18.0, 17.0, 25.0])
    R = rng.rand(350, 3) * [18.0, 17.0, 12.0]
    pbc = np.asarray(pbc)
    got = cell_list_neighbor_list(R, CUTOFF, cell, pbc)
    want = neighbor_list(R, CUTOFF, cell, pbc)
    assert_edges_equal(got, want)
    assert_edges_equal(got, cell_list_numpy(R, CUTOFF, cell, pbc))
    assert np.abs(got[2]).max() == 1
    assert not got[2][:, ~pbc].any()


def test_small_periodic_cell_takes_the_brute_force():
    """A periodic cell under 3 cutoffs high is not the C++ list's
    (``UnsupportedGeometry``): ``cell_list_neighbor_list`` hands it to the
    brute force, several images deep."""
    R, cell = fcc_argon(2, jitter=0.2, seed=5)
    pbc = np.ones(3, bool)
    with pytest.raises(cellist.UnsupportedGeometry):
        cellist.neighbor_list(R, CUTOFF, cell, pbc)
    got = cell_list_neighbor_list(R, CUTOFF, cell, pbc)
    assert_edges_equal(got, neighbor_list(R, CUTOFF, cell, pbc))
    assert_edges_equal(got, cell_list_numpy(R, CUTOFF, cell, pbc))


def test_overflow_retry_returns_every_pair():
    """A dense cluster needs more than the first guess of 64 pairs an
    atom: the retry with the count the C++ list asks for returns them
    all."""
    R = np.random.RandomState(2).rand(200, 3) * 6.0
    got = cellist.neighbor_list(R, 11.0)
    assert len(got[0]) == 200 * 199
    assert_edges_equal(got, neighbor_list(R, 11.0))


def test_failed_build_raises_with_the_compiler_message(tmp_path):
    bad = tmp_path / "cellist.cpp"
    bad.write_text("extern \"C\" long long cellist_neighbor_list( {\n")
    with pytest.raises(cellist.NativeBuildError, match="error"):
        cellist.build(str(bad), str(tmp_path / "build"))
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]
    with pytest.raises(cellist.NativeBuildError, match="not found"):
        cellist.build(cellist.SOURCE, str(tmp_path / "build"),
                      compiler="no-such-compiler-g++")


def _build_into(args):
    source, build_dir = args
    return cellist.build(source, build_dir)


def test_library_is_named_by_the_source_and_built_once(tmp_path):
    """An edited source gets a library of its own; three processes
    building at once leave one library and no temporary file."""
    src = tmp_path / "cellist.cpp"
    shutil.copy(cellist.SOURCE, src)
    build_dir = str(tmp_path / "build")
    with mp.get_context("spawn").Pool(3) as pool:
        paths = pool.map(_build_into, [(str(src), build_dir)] * 3)
    assert len(set(paths)) == 1
    assert sorted(f for f in os.listdir(build_dir)
                  if not f.endswith(".lock")) == [os.path.basename(paths[0])]
    with open(src, "a") as f:
        f.write("\n// edited\n")
    assert cellist.library_path(str(src), build_dir) != paths[0]
    assert cellist.load(str(src), build_dir).cellist_neighbor_list
    assert len([f for f in os.listdir(build_dir)
                if f.endswith(".so")]) == 2
