"""PyTorch port: the message kernels' schedules on the CPU.

The forward kernels (``csrc/colblock_message.cu``) walk every real slot by
(destination column, destination row) in row ranges of about equal edge
count (``colblock.destination_schedule``); the backward kernels cut the
source-sorted slots the same way (``colblock.row_groups``).  The kernels
run only on the card; here the schedule itself is checked, and a plain
walk over it in the forward kernel's summation order (written below) is
held to the twin and to the JAX package's message on the same numpy
inputs, at the message tolerance (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu.ops import colblock as jcb
from schnetpack_tpu.ops import colblock_geo as jgeo
from schnetpack_tpu.ops.radial import gaussian_rbf_params
from schnetpack_tpu_torch.ops import colblock_message as msg
from schnetpack_tpu_torch.ops.colblock import (
    column_gather, column_geometry, destination_order,
    destination_schedule, row_groups, source_order,
)
from torch_port_cases import (
    MSG_ATOL, MSG_RTOL, message_case, torch_message_args,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _refs(seed):
    c = message_case(seed=seed)
    return c, *torch_message_args(c)


@pytest.mark.parametrize("seed", [0, 2, 5])
def test_destination_order_sorts_the_real_slots(seed):
    """The sorted slots are the real slots, each once, ordered by
    (column, destination row) and by slot within a row; padded slots
    come last; the counts are the slots of each destination row."""
    _, _, refs, _ = _refs(seed)
    nx, ny, Ktot = refs.qcol.shape
    dsorted, cnt = destination_order(refs)
    qcol, dcol = refs.qcol.reshape(-1), refs.dcol.reshape(-1)
    n_real = int((qcol >= 0).sum())
    head = dsorted[:n_real].long()
    assert torch.equal(torch.sort(head).values,
                       torch.nonzero(qcol >= 0).reshape(-1))
    assert bool((qcol[dsorted[n_real:].long()] < 0).all())
    key = (head // Ktot) * refs.P + dcol[head]
    assert bool((key[1:] >= key[:-1]).all())
    same = key[1:] == key[:-1]
    assert bool((head[1:][same] > head[:-1][same]).all())
    assert torch.equal(cnt, torch.bincount(key, minlength=nx * ny * refs.P))


@pytest.mark.parametrize("G", [1, 2, 3, 5])
def test_row_groups_cover_every_row_once(G):
    """The G ranges of a column cover its rows [0, P) once, in order; their
    slot bounds agree with the counts; each range's count is within one
    row's degree of an equal share of the column; on the destination and
    on the source order alike."""
    _, _, refs, _ = _refs(1)
    nx, ny, _ = refs.qcol.shape
    for _, cnt in (destination_order(refs), source_order(refs)[:2]):
        per_row = cnt.view(nx * ny, refs.P)
        grp = row_groups(per_row, G)
        assert grp.shape == (nx * ny, G + 1, 2) and grp.dtype == torch.int32
        rows, edges = grp[..., 0].long(), grp[..., 1].long()
        assert bool((rows[:, 0] == 0).all()) and bool(
            (rows[:, -1] == refs.P).all())
        assert bool((rows[:, 1:] >= rows[:, :-1]).all())
        start = torch.cat([per_row.new_zeros(1), per_row.sum(1).cumsum(0)])
        assert torch.equal(edges[:, 0], start[:-1])
        assert torch.equal(edges[:, -1], start[1:])
        cum = torch.cat([per_row.new_zeros(nx * ny, 1), per_row.cumsum(1)], 1)
        assert torch.equal(edges - edges[:, :1], cum.gather(1, rows))
        counts = (edges[:, 1:] - edges[:, :-1]).double()
        share = per_row.sum(1, keepdim=True).double() / G
        deg = per_row.max(1, keepdim=True).values.double()
        assert bool(((counts - share).abs() <= deg).all())


def test_destination_schedule_is_cached_per_refs():
    _, _, refs, _ = _refs(3)
    order = destination_order(refs)
    a = destination_schedule(refs, 3)
    assert destination_schedule(refs, 3) is a
    assert destination_order(refs) is order
    b = destination_schedule(refs, 2)
    assert b is not a and b[0] is a[0]
    assert b[1].shape[1] == 3 and a[1].shape[1] == 4


@pytest.mark.parametrize("n_cols,slots,want", [
    (100, 264, 5), (100, 396, 11), (100, 528, 5), (9, 132, 14), (1, 8, 8)])
def test_wave_groups_fill_the_last_wave(n_cols, slots, want):
    """G avoids a last wave of a few blocks: at 100 columns and 264 slots,
    G = 3 would run 300 blocks in two waves, G = 5 runs 500 in two."""
    assert msg.wave_groups(n_cols, slots, 16) == want


def _walk(c, t, refs, cw, G):
    """The forward kernel's sums, in its order: per block (column, row
    range) its slots in destination order, the slots with fcut = 0 skipped,
    each destination row's dq and dmu summed in f32 slot by slot and
    stored once; rows without a slot stay zero."""
    F = t["x"].shape[1] // 3
    rbf, dirs = column_geometry(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    xj = column_gather(t["x"], refs).reshape(-1, 3 * F).numpy()
    muj = column_gather(t["mu"], refs).reshape(-1, 3 * F).numpy()
    rbf = rbf.reshape(-1, rbf.shape[-1]).numpy()
    dirs = dirs.reshape(-1, 3).numpy()
    W = rbf @ t["FW"].numpy()
    nx, ny, Ktot = refs.qcol.shape
    dsorted, grp = destination_schedule(refs, G)
    dsorted, grp = dsorted.numpy(), grp.numpy()
    dcol = refs.dcol.reshape(-1).numpy()
    out = np.zeros((nx * ny * refs.P, 4 * F), np.float32)
    for col in range(nx * ny):
        for g in range(G):
            (r0, e0), (r1, e1) = grp[col, g], grp[col, g + 1]
            for s in dsorted[e0:e1]:
                row = col * refs.P + dcol[s]
                assert col * refs.P + r0 <= row < col * refs.P + r1
                if rbf[s, -1] == 0.0:   # fcut = 0: adds nothing
                    continue
                xq, xr, xm = np.split(xj[s] * W[s], 3)
                out[row] += np.concatenate(
                    [xq] + [xr * dirs[s, k] + xm * muj[s, k * F:(k + 1) * F]
                            for k in range(3)])
    return out[:, :F], out[:, F:]


def _jax_message(c):
    refs = jcb.ColRefs.from_layout(c["lay"])
    centers, widths = gaussian_rbf_params(c["B"], c["cutoff"], 0.0)
    geo = jgeo.column_geometry(jnp.asarray(c["Rs"]), jnp.asarray(c["coff_fm"]),
                               refs, centers, widths, c["cutoff"])
    return [np.asarray(o) for o in jcb.painn_message_columns_fm(
        jnp.asarray(c["x"]), jnp.asarray(c["mu"]), geo, jnp.asarray(c["FW"]),
        refs)]


@pytest.mark.parametrize("seed,G", [(0, 1), (2, 3), (4, 4)])
def test_destination_walk_matches_twin_and_jax(seed, G):
    c, t, refs, cw = _refs(seed)
    got = _walk(c, t, refs, cw, G)
    twin = msg.msg_fwd_plain(t["x"], t["mu"], t["Rs"], t["FW"], t["coff_fm"],
                             cw, refs, c["cutoff"])
    for g, w, j in zip(got, twin, _jax_message(c)):
        np.testing.assert_allclose(g, w.numpy(), MSG_RTOL, MSG_ATOL)
        np.testing.assert_allclose(g, j, MSG_RTOL, MSG_ATOL)
    # some real slots lie out of the cutoff: the walk skipped them
    rbf, _ = column_geometry(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    assert bool(((rbf[..., -1] == 0) & (refs.qcol >= 0)).any())
    assert jax.default_backend() == "cpu"
