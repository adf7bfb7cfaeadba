"""PyTorch port, the flat and dense layouts' aggregation ops against the
JAX package: ``ops/scatter.py`` (segment sums, means and softmax, the row
gather) and ``ops/neighbor_gather.py`` (the scatter-free gather and its
VJP, the reverse-edge map).

Inputs are made with numpy from fixed seeds.  The reference's
semantics are part of the contract: up to 128 segments a float input of
ndim <= 2 has its non-finite elements zeroed before the sum, out-of-range
segment ids are dropped, and the gather fills out-of-range rows with NaN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu.data.loader import PaddingSpec, collate
from schnetpack_tpu.ops import neighbor_gather as jng
from schnetpack_tpu.ops import scatter as jscatter
from schnetpack_tpu.transform.neighborlist import NeighborListTransform
from schnetpack_tpu import properties as P
from schnetpack_tpu_torch.ops import neighbor_gather as tng
from schnetpack_tpu_torch.ops import scatter as tscatter

# f32 sums in another order than XLA's
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _segments(n_rows, n_seg, shape, seed, poison=False):
    """Rows x [n_rows, *shape], segment ids with a few out of range (the
    padding id n_seg, and -1), and with ``poison`` an inf and a NaN in
    two rows of the padding segment."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n_rows, *shape).astype(np.float32)
    idx = np.sort(rng.randint(0, n_seg, n_rows)).astype(np.int32)
    idx[-3:] = n_seg
    idx[-1] = -1
    if poison:
        x[-3].flat[0] = np.inf
        x[-2].flat[-1] = np.nan
    return x, idx


@pytest.mark.parametrize("n_seg,shape,poison", [
    (7, (), True), (7, (5,), True), (100, (4,), True), (7, (3, 4), False),
    (200, (6,), False), (200, (3, 4), False)],
    ids=["few-1d-nonfinite", "few-2d-nonfinite", "128-2d-nonfinite",
         "few-3d", "many-2d", "many-3d"])
def test_segment_sum_and_mean_match_jax(n_seg, shape, poison):
    """The sums and means, with out-of-range ids dropped and, up to 128
    segments, non-finite elements zeroed."""
    x, idx = _segments(300, n_seg, shape, seed=n_seg, poison=poison)
    for name in ("segment_sum", "segment_mean"):
        want = np.asarray(getattr(jscatter, name)(
            jnp.asarray(x), jnp.asarray(idx), n_seg))
        got = getattr(tscatter, name)(torch.tensor(x), torch.tensor(idx),
                                      n_seg).numpy()
        assert np.isfinite(want).all() == np.isfinite(got).all()
        np.testing.assert_allclose(got, want, RTOL, ATOL, err_msg=name)
    if poison:
        assert np.isfinite(got).all()


def test_segment_sum_gradient_matches_jax():
    """The VJP of the sum, through the non-finite zeroing."""
    x, idx = _segments(120, 9, (4,), seed=3, poison=True)
    g = np.random.RandomState(4).randn(9, 4).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jscatter.segment_sum(a, jnp.asarray(idx), 9),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x).requires_grad_(True)
    (got,) = torch.autograd.grad(
        tscatter.segment_sum(xt, torch.tensor(idx), 9), xt, torch.tensor(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches_jax(masked):
    """Softmax within segments, an empty segment and a padding id among
    them, with and without a mask."""
    x, idx = _segments(90, 12, (), seed=5)
    idx[idx == 4] = 5                   # segment 4 is empty
    mask = (np.random.RandomState(6).rand(90) > 0.3).astype(np.float32)
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.tensor(mask) if masked else None
    want = np.asarray(jscatter.segment_softmax(
        jnp.asarray(x), jnp.asarray(idx), 12, jmask))
    got = tscatter.segment_softmax(torch.tensor(x), torch.tensor(idx), 12,
                                   tmask).numpy()
    np.testing.assert_allclose(got, want, RTOL, ATOL)


def test_gather_fills_out_of_range_rows_as_jax():
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    idx = np.array([0, 7, -1, -8, -9, 8, 3], np.int32)
    want = np.asarray(jscatter.gather(jnp.asarray(x), jnp.asarray(idx)))
    got = tscatter.gather(torch.tensor(x), torch.tensor(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[[4, 5]]).all()


def _dense_batch(seed=0, K=12):
    """A JAX collate of three molecules with the dense layout and its
    reverse map (``data/loader.py:211-240``)."""
    rng = np.random.RandomState(seed)
    mols = [NeighborListTransform(3.5)({
        P.Z: np.full(n, 18, np.int64), P.R: rng.rand(n, 3) * 4.0,
        P.cell: np.zeros((3, 3)), P.pbc: np.zeros(3, bool)})
        for n in (5, 8, 11)]
    return collate(mols, PaddingSpec(28, 512, 4, n_neighbors=K))


def test_neighbor_gather_and_its_vjp_match_jax():
    """Forward x[nbh] and the reverse-map VJP against ``jax.vjp`` of the
    JAX ``custom_vjp``, on a [A, 3, F] table."""
    b = _dense_batch()
    A, K = b[P.nbh_idx].shape
    rng = np.random.RandomState(1)
    x = rng.randn(A, 3, 5).astype(np.float32)
    g = rng.randn(A, K, 3, 5).astype(np.float32)
    nbh, rev, mask = b[P.nbh_idx], b[P.nbh_rev], b[P.nbh_mask]
    want, vjp = jax.vjp(
        lambda a: jng.neighbor_gather(a, jnp.asarray(nbh), jnp.asarray(rev),
                                      jnp.asarray(mask)), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x).requires_grad_(True)
    got = tng.neighbor_gather(xt, torch.tensor(nbh), torch.tensor(rev),
                              torch.tensor(mask))
    (dx,) = torch.autograd.grad(got, xt, torch.tensor(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), RTOL, ATOL)
    # the scatter it replaces, on the real slots
    gm = torch.tensor(g) * torch.tensor(mask)[..., None, None]
    scatter = torch.zeros_like(xt).index_add(
        0, torch.tensor(nbh).reshape(-1).long(), gm.reshape(A * K, 3, 5))
    np.testing.assert_allclose(dx.numpy(), scatter.numpy(), RTOL, ATOL)


def _edges(seed):
    """The real edges of a periodic random box: (i, j, offsets, slots)."""
    from schnetpack_tpu_torch.transform.neighborlist import (
        cell_list_neighbor_list,
    )

    rng = np.random.RandomState(seed)
    cell = np.eye(3) * 7.0
    i, j, S = cell_list_neighbor_list(rng.rand(40, 3) * 7.0, 3.2, cell,
                                      np.ones(3, bool))
    slots = np.arange(len(i)) - np.searchsorted(i, i)
    return i, j, S @ cell, slots


def test_build_reverse_map_is_jax_bit_for_bit():
    i, j, off, slots = _edges(2)
    K = int(slots.max()) + 3
    want = jng.build_reverse_map(i, j, off, slots, 40, K)
    got = tng.build_reverse_map(i, j, off, slots, 40, K)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # each real slot's reverse points back at it
    flat_i = np.repeat(np.arange(40), K).reshape(40, K)
    real = np.zeros((40, K), bool)
    real[i, slots] = True
    back = got.reshape(-1)[got[real]]
    np.testing.assert_array_equal(back, (flat_i * K + np.arange(K))[real])
    empty = tng.build_reverse_map(i[:0], j[:0], off[:0], slots[:0], 5, 4)
    assert empty.shape == (5, 4) and not empty.any()


def test_build_reverse_map_refuses_an_asymmetric_list():
    i, j, off, slots = _edges(3)
    keep = np.ones(len(i), bool)
    keep[np.nonzero(i == 0)[0][0]] = False      # drop one direction
    args = (i[keep], j[keep], off[keep], slots[keep], 40, int(slots.max()) + 1)
    with pytest.raises(ValueError, match="not symmetric"):
        jng.build_reverse_map(*args)
    with pytest.raises(ValueError, match="not symmetric"):
        tng.build_reverse_map(*args)
