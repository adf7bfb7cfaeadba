"""PyTorch port: K18/K19's cell index mode and stack schedules on the CPU.

K18 and K19 are the column message bodies (``csrc/colblock_message.cu``,
``csrc/colblock_message_bwd.cu``) run on the 27-cell layout's stack view
(``csrc/cellblock.cuh``): the nz cells of an (x, y) are one column of
nz*C rows, and each slot's code is decoded in the kernels
(``CellStack::decode``).  The kernels run only on the card; here the
decode, written in torch as the kernels do it, is held to the twins'
``decode_cell_j``; the stack schedules cached on ``CellRefs`` are checked;
and plain walks over them in the kernels' orders (the forward's
destination runs over the compacted slots, the backward's source-row
runs) are held to the twins and to the JAX package's ``_message_xla`` and
its VJP on the same numpy inputs, at the message tolerance, on an aliased
2-cell grid and a 3-cell grid per axis.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu.ops import cellblock as jcellblock
from schnetpack_tpu.ops import painn_fused as jpainn_fused
from schnetpack_tpu_torch.ops import cellblock_gather as cg
from schnetpack_tpu_torch.ops import painn_fused as pf
from schnetpack_tpu_torch.ops.cellblock import OFFSETS
from torch_port_cases import MSG_ATOL, MSG_RTOL, cell_case

#: the boxes: 2 cells per axis (offsets alias) and 3
CASES = {"aliased": dict(seed=9), "aliased4": dict(seed=4),
         "grid3": dict(n=200, L=13.0, seed=6)}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jcellblock, "IMPL", "xla")


def _case(name):
    c = cell_case(**CASES[name])
    return c, cg.CellRefs(torch.tensor(c["qidx"]))


def _wrap(v, n):
    return v + torch.where(v < 0, n, 0) - torch.where(v >= n, n, 0)


def stack_decode(refs):
    """``CellStack::decode`` and the wrap-mode source stack in torch, per
    slot e (int64 [A'*K]): bucket c9, source row in the source stack,
    destination row in the own stack, own stack, source stack (-1 where
    the slot is padded)."""
    nx, ny, nz, C, K = refs.dims
    _, P, Kt = refs.stack
    q = refs.qidx.reshape(-1).long()
    e = torch.arange(q.numel())
    col, k = e // Kt, e % Kt
    o, s, a = q.clamp(min=0) // C, q.clamp(min=0) % C, k // K
    sz = _wrap(a // C + o % 3 - 1, nz)
    c9 = o // 3
    sx = _wrap(col // ny + c9 // 3 - 1, nx)
    sy = _wrap(col % ny + c9 % 3 - 1, ny)
    scol = torch.where(q >= 0, sx * ny + sy, -1)
    return c9, sz * C + s, a, col, scol


@pytest.mark.parametrize("name", list(CASES))
def test_stack_decode_is_decode_cell_j(name):
    """The kernels' decode names every real slot's source row and
    destination row as the twins do, and its bucket is the column
    layout's c9 = (dx+1)*3 + (dy+1) of the slot's offset."""
    _, refs = _case(name)
    nx, ny, nz, C, K = refs.dims
    _, P, _ = refs.stack
    c9, src, dst, col, scol = stack_decode(refs)
    j, valid = cg.decode_cell_j(refs)
    real = valid.reshape(-1)
    assert torch.equal((scol * P + src)[real], j.reshape(-1)[real])
    e = torch.arange(real.numel())
    assert torch.equal(col * P + dst, e // K)
    off = torch.tensor(OFFSETS)[refs.qidx.reshape(-1).long().clamp(min=0)
                                // C]
    assert torch.equal(c9[real], ((off[:, 0] + 1) * 3 + off[:, 1] + 1)[real])
    if name.startswith("aliased"):
        assert max(nx, ny, nz) == 2
    else:
        assert min(nx, ny, nz) >= 3


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("G", [1, 2, 3, 5])
def test_stack_schedules_list_every_real_slot_once(name, G):
    """Both schedules list each real slot once within their ranges; the
    ranges of a stack partition its rows [0, P') in order, and every slot
    of a range has its destination (forward) or own source (backward) row
    in that range, the forward's in slot order."""
    _, refs = _case(name)
    n_cols, P, _ = refs.stack
    _, src, dst, col, scol = stack_decode(refs)
    real = refs.qidx.reshape(-1) >= 0
    n_real = int(real.sum())
    for order, grp, row, owner in [
            (*cg.stack_destination_schedule(refs, G), dst, col),
            (*cg.stack_source_schedule(refs, G), src, scol)]:
        assert grp.shape == (n_cols, G + 1, 2) and grp.dtype == torch.int32
        rows, edges = grp[..., 0].long(), grp[..., 1].long()
        assert bool((rows[:, 0] == 0).all() and (rows[:, -1] == P).all())
        assert bool((rows[:, 1:] >= rows[:, :-1]).all())
        assert int(edges[0, 0]) == 0 and int(edges[-1, -1]) == n_real
        assert torch.equal(edges[1:, 0], edges[:-1, -1])
        listed = []
        for c in range(n_cols):
            for g in range(G):
                (r0, e0), (r1, e1) = grp[c, g].tolist(), grp[c, g + 1].tolist()
                slots = order[e0:e1].long()
                assert bool(real[slots].all())
                assert bool((owner[slots] == c).all())
                assert bool(((row[slots] >= r0) & (row[slots] < r1)).all())
                listed.append(slots)
        listed = torch.cat(listed)
        assert torch.equal(torch.sort(listed).values,
                           torch.nonzero(real).reshape(-1))
    dsorted, _ = cg.stack_destination_schedule(refs, G)
    assert torch.equal(dsorted[:n_real].long(),
                       torch.nonzero(real).reshape(-1))
    assert cg.stack_destination_schedule(refs, G)[0] is dsorted


def _slot_arrays(c, refs):
    """Per slot (numpy, [A'*K, .]): the basis row, direction, source row
    (the stack decode's, -1 padded) and destination row."""
    _, P, _ = refs.stack
    K = refs.dims[4]
    _, src, dst, col, scol = stack_decode(refs)
    j = torch.where(scol >= 0, scol * P + src, -1).numpy()
    return (c["rbf"].reshape(-1, c["rbf"].shape[-1]), c["dir"].reshape(-1, 3),
            j, (col * P + dst).numpy(), K)


def walk_fwd(c, refs, G):
    """K18's sums in its order: per block (stack, row range) its slots in
    slot order, the slots with a zero basis row dropped (the ballot), each
    destination row's dq and dmu summed in f32 slot by slot and stored
    once; rows without a slot are 0."""
    rbf, dirs, j, dst, _ = _slot_arrays(c, refs)
    xmu, FW = c["xmu"], c["FW"]
    F = FW.shape[1] // 3
    out = np.zeros((xmu.shape[0], 4 * F), np.float32)
    dsorted, grp = (t.numpy() for t in cg.stack_destination_schedule(refs, G))
    n_cols, P, _ = refs.stack
    for col in range(n_cols):
        for g in range(G):
            (r0, e0), (r1, e1) = grp[col, g], grp[col, g + 1]
            for e in dsorted[e0:e1]:
                assert col * P + r0 <= dst[e] < col * P + r1
                if not rbf[e].any():
                    continue
                x, mu = xmu[j[e], :3 * F], xmu[j[e], 3 * F:]
                xq, xr, xm = np.split(x * (rbf[e] @ FW), 3)
                out[dst[e]] += np.concatenate(
                    [xq] + [xr * dirs[e, k] + xm * mu[k * F:(k + 1) * F]
                            for k in range(3)])
    return out[:, :F], out[:, F:]


def walk_bwd(c, refs, G):
    """K19's sums in its order: per block its slots in source order, each
    own source row's dx and dmu cotangents summed in f32 over its run and
    stored once (rows without a slot 0), every slot's grbf and gdir at its
    own position, gFW summed per block and the blocks in f64."""
    rbf, dirs, j, dst, K = _slot_arrays(c, refs)
    xmu, FW, g_dq, g_dmu = c["xmu"], c["FW"], c["g_dq"], c["g_dmu"]
    F = FW.shape[1] // 3
    dxmu = np.zeros_like(xmu)
    grbf, gdir = np.zeros_like(rbf), np.zeros_like(dirs)
    gFW = np.zeros(FW.shape, np.float64)
    esorted, grp = (t.numpy() for t in cg.stack_source_schedule(refs, G))
    n_cols, P, _ = refs.stack
    for col in range(n_cols):
        for g in range(G):
            (r0, e0), (r1, e1) = grp[col, g], grp[col, g + 1]
            part = np.zeros(FW.shape, np.float32)
            for e in esorted[e0:e1]:
                assert col * P + r0 <= j[e] < col * P + r1
                x, mu = xmu[j[e], :3 * F], xmu[j[e], 3 * F:].reshape(3, F)
                W = rbf[e] @ FW
                gm = g_dmu[dst[e]].reshape(3, F)
                gxW = np.concatenate([g_dq[dst[e]], dirs[e] @ gm,
                                      (gm * mu).sum(0)])
                dmumu = x[2 * F:] * W[2 * F:]
                dxmu[j[e]] += np.concatenate(
                    [gxW * W, (gm * dmumu).reshape(-1)])
                gW = gxW * x
                grbf[e] = FW @ gW
                gdir[e] = gm @ (x[F:2 * F] * W[F:2 * F])
                part += np.outer(rbf[e], gW)
            gFW += part
    A = xmu.shape[0]
    return dxmu, grbf.reshape(A, K, -1), gdir.reshape(A, K, 3), gFW


def _jax(c):
    names = ("xmu", "rbf", "dir", "FW")
    qidx = jnp.asarray(c["qidx"])
    out, vjp = jax.vjp(lambda *a: jpainn_fused._message_xla(*a, qidx),
                       *[jnp.asarray(c[k]) for k in names])
    grads = vjp((jnp.asarray(c["g_dq"]), jnp.asarray(c["g_dmu"])))
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name,G", [("aliased", 1), ("aliased4", 3),
                                    ("grid3", 2)])
def test_schedule_walks_match_twins_and_jax(name, G):
    """The walks against the twins and JAX, with every fourth real slot's
    basis row zero (a slot outside the cutoff), which the forward drops
    and the backward keeps."""
    c, refs = _case(name)
    rbf = c["rbf"].reshape(-1, c["rbf"].shape[-1])
    rbf[np.flatnonzero(c["qidx"].reshape(-1) >= 0)[::4]] = 0.0
    t = [torch.tensor(c[k]) for k in ("xmu", "rbf", "dir", "FW")]
    cots = [torch.tensor(c[k]) for k in ("g_dq", "g_dmu")]
    (dq, dmu), jgrads = _jax(c)
    fwd = walk_fwd(c, refs, G)
    for got, twin, want in zip(fwd, pf.cell_msg_fwd_plain(*t, refs),
                               (dq, dmu)):
        np.testing.assert_allclose(got, twin.numpy(), MSG_RTOL, MSG_ATOL)
        np.testing.assert_allclose(got, want, MSG_RTOL, MSG_ATOL)
    bwd = walk_bwd(c, refs, G)
    twin = pf.cell_msg_bwd_plain(*t, refs, *cots)
    for n, got, tw, want in zip(("dxmu", "grbf", "gdir", "gFW"), bwd, twin,
                                jgrads):
        np.testing.assert_allclose(got, tw.numpy(), MSG_RTOL, MSG_ATOL,
                                   err_msg=n)
        np.testing.assert_allclose(got, want, MSG_RTOL, MSG_ATOL, err_msg=n)
    # the cells' padding rows are 0
    pad_rows = c["lay"].slot_mask == 0
    assert bool(pad_rows.any())
    assert not np.abs(fwd[0][pad_rows]).any()
    assert not np.abs(bwd[0][pad_rows]).any()
