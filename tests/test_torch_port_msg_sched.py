"""PyTorch port: the message kernels' schedules on the CPU.

The forward kernels (``csrc/colblock_message.cu``) walk every real slot by
(destination column, destination row) in row ranges of about equal edge
count (``colblock.destination_schedule``); the backward kernels cut the
source-sorted slots the same way (``colblock.row_groups``).  The kernels
run only on the card; here the schedule itself is checked, and a plain
walk over it in the forward kernel's summation order (written below) is
held to the twin and to the JAX package's message on the same numpy
inputs, at the message tolerance (f32 sums in another order).  The walk
also replays the kernels' reduced-precision instances (``ops/precision.py``)
against the twins at the same pieces: the features as the kernels load
them and each edge's message rounded before its row sum, in the forward
kernel's arithmetic; and the backward's P3 product grbf = bf16(gW)
bf16(FW)^T of the bf16 instance.
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
    column_gather, column_geometry, decode_i, decode_j, destination_order,
    destination_schedule, painn_message, row_groups, source_order,
    source_schedule,
)
from schnetpack_tpu_torch.ops.precision import round_pieces
from test_torch_port_mixing import _split, mma
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
    dsorted, cnt, _ = destination_order(refs)
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
    for _, cnt, _ in (destination_order(refs), source_order(refs)):
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


def _rnd(a, pieces):
    return round_pieces(torch.as_tensor(a), pieces).numpy()


def _walk(c, t, refs, cw, G, pieces=3):
    """The forward kernel's sums, in its order: per block (column, row
    range) its slots in destination order, the slots with fcut = 0 skipped,
    each destination row's dq and dmu summed in f32 slot by slot and
    stored once; rows without a slot stay zero.  At ``pieces`` < 3 the
    instance of that mode: x and mu as loaded (``round_pieces``), and each
    edge's message formed as the kernel forms it (dq = x w; dmu =
    fma(x_m w_m, mu, x_r w_r dir), the fma's one rounding from float64)
    and rounded before its sum."""
    F = t["x"].shape[1] // 3
    rbf, dirs = column_geometry(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    xj = _rnd(column_gather(t["x"], refs).reshape(-1, 3 * F), pieces)
    muj = _rnd(column_gather(t["mu"], refs).reshape(-1, 3 * F), pieces)
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
                if pieces == 3:
                    out[row] += np.concatenate(
                        [xq] + [xr * dirs[s, k] + xm * muj[s, k * F:(k + 1)
                                                           * F]
                                for k in range(3)])
                    continue
                mu3 = muj[s].reshape(3, F).astype(np.float64)
                edge = [xq] + [(xm.astype(np.float64) * mu3[k]
                                + (xr * dirs[s, k])).astype(np.float32)
                               for k in range(3)]
                out[row] += _rnd(np.concatenate(edge), pieces)
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


#: a kernel instance against its twin at the same pieces: one rounding
#: flip of the mode's ulp per edge (2^-15 of the term at two pieces, 2^-7
#: at one), S the sum of the terms' absolute values, beside the f32 one
REDUCED_ULP = {2: 2.0 ** -15, 1: 2.0 ** -7}


@pytest.mark.parametrize("pieces", [2, 1])
def test_reduced_walk_matches_twin(pieces):
    """The forward kernel's mixed and bf16 arithmetic, replayed on its
    schedule, against the twin at the same pieces."""
    c, t, refs, cw = _refs(4)
    got = _walk(c, t, refs, cw, 3, pieces)
    twin = msg.msg_fwd_plain(t["x"], t["mu"], t["Rs"], t["FW"], t["coff_fm"],
                             cw, refs, c["cutoff"], pieces)
    rbf, dirs = column_geometry(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    S = painn_message(t["x"].abs(), t["mu"].abs(), rbf.abs(), dirs.abs(),
                      t["FW"].abs(), refs)
    for g, w, s in zip(got, twin, S):
        lim = (REDUCED_ULP[pieces] + MSG_RTOL) * s.numpy() + MSG_ATOL
        assert (np.abs(g - w.numpy()) <= lim).all()
    # the mode is in effect
    assert not np.allclose(got[1], _walk(c, t, refs, cw, 3)[1], 0, 1e-7)


def test_bf16_p3_product_matches_twin():
    """P3 of the bf16 backward: per slot gW = [g_q x_q, (g . dir) x_r,
    (g . mu) x_m] from the bf16 loads in f32, then grbf = sum over 3F of
    bf16(gW) bf16(FW) with exact products and f32 sums (mma.sync
    m16n8k16), against the twin's grbf (the VJP of its bf16 filter)."""
    c, t, refs, cw = _refs(5)
    F = t["x"].shape[1] // 3
    rbf, dirs = column_geometry(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    leaf = rbf.detach().requires_grad_(True)
    (grbf,) = torch.autograd.grad(
        painn_message(t["x"], t["mu"], leaf, dirs, t["FW"], refs, 1), leaf,
        (t["g_dq"], t["g_dmu"]))
    from schnetpack_tpu_torch.ops.colblock import decode_i
    i, _ = decode_i(refs)
    real = (refs.qcol >= 0).reshape(-1).numpy()
    xj = _rnd(column_gather(t["x"], refs).reshape(-1, 3 * F), 1)[real]
    muj = _rnd(column_gather(t["mu"], refs).reshape(-1, 3 * F), 1)[real]
    g = np.concatenate([t["g_dq"], t["g_dmu"]], 1)
    g = _rnd(g[i.reshape(-1).numpy()[real]], 1)
    d = dirs.reshape(-1, 3).numpy()[real]
    gm = g[:, F:].reshape(-1, 3, F)
    gp1 = (gm * d[:, :, None]).sum(1, dtype=np.float32)
    gp2 = (gm * muj.reshape(-1, 3, F)).sum(1, dtype=np.float32)
    gW = np.concatenate([g[:, :F] * xj[:, :F], gp1 * xj[:, F:2 * F],
                         gp2 * xj[:, 2 * F:]], 1)
    FW = _rnd(t["FW"].numpy(), 1)
    got = _rnd(gW, 1) @ FW.T
    want = grbf.reshape(-1, grbf.shape[-1]).numpy()[real]
    S = np.abs(gW) @ np.abs(FW).T
    lim = (REDUCED_ULP[1] + MSG_RTOL) * S + MSG_ATOL
    assert (np.abs(got - want) <= lim).all()


# ------------------------------------------- the general instances' walks
def _jax64(fn, *args):
    """``fn`` of the JAX package on float64 copies (x64 for this call)."""
    with jax.enable_x64(True):
        return jax.tree.map(np.asarray, fn(*[
            jnp.asarray(a, jnp.float64) if isinstance(a, np.ndarray) else a
            for a in args]))


def _gen_inputs(F, B, seed):
    """``message_case`` at (F, B) in float64: xmu [A', 6F], the edge-major
    geometry of the case's positions, FW_aug and the cotangents."""
    c = message_case(F=F, B=B, seed=seed)
    t, refs, cw = torch_message_args(c)
    rbf, dirs = column_geometry(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    d = {k: t[k].double().numpy() for k in ("x", "mu", "FW", "g_dq",
                                              "g_dmu")}
    return (c, refs, np.concatenate([d["x"], d["mu"]], 1),
            rbf.double().numpy(), dirs.double().numpy(), d["FW"],
            d["g_dq"], d["g_dmu"])


def _tiles(F):
    """The general instances' feature tiles: [z NT, min(F, z NT + NT))."""
    Z, NT = msg.gen_tiles(F), msg.gen_threads(F)
    return [np.arange(z * NT, min(F, z * NT + NT)) for z in range(Z)]


def _gen_fwd_walk(refs, xmu, rbf, dirs, FW, G, E=32):
    """``csrc/colblock_message_gen.cu::msg_fwd_gen_kernel`` in float64 on
    the edge-major geometry (K20's view): block (column, range, tile)
    walks its destination rows' slots in chunks of E, skips a slot whose
    basis row is zero, and sums each open row's dq and dmu for the tile's
    features, stored when the row's run ends (rows without a slot: 0).
    Returns [A', 4F] and how often each element was written."""
    nx, ny, Ktot = refs.qcol.shape
    P, B1, F = refs.P, FW.shape[0], FW.shape[1] // 3
    dsorted, grp = (a.numpy() for a in destination_schedule(refs, G))
    src = decode_j(refs)[0].reshape(-1).numpy()
    dcol = refs.dcol.reshape(-1).numpy()
    rbf, dirs = rbf.reshape(-1, B1), dirs.reshape(-1, 3)
    out = np.zeros((nx * ny * P, 4 * F))
    n_out = np.zeros(out.shape, np.int64)
    for col in range(nx * ny):
        for g in range(G):
            (r0, e0), (r1, e1) = grp[col, g], grp[col, g + 1]
            for f in _tiles(F):
                cols = np.concatenate([f + k * F for k in range(4)])
                run, nxt, acc = -1, r0, np.zeros((4, len(f)))

                def put(r, v):
                    out[col * P + r, cols] = v.reshape(-1)
                    n_out[col * P + r, cols] += 1

                for base in range(e0, e1, E):
                    for s in dsorted[base:min(base + E, e1)]:
                        if not rbf[s].any():   # fcut = 0 adds exactly 0
                            continue
                        d = dcol[s]
                        if d != run:
                            if run >= 0:
                                put(run, acc)
                                nxt = run + 1
                            for r in range(nxt, d):
                                put(r, np.zeros((4, len(f))))
                            run, nxt, acc = d, d, np.zeros((4, len(f)))
                        w = rbf[s] @ FW
                        x = xmu[src[s]]
                        acc[0] += x[f] * w[f]
                        for k in range(3):
                            acc[1 + k] += (x[2 * F + f] * w[2 * F + f]
                                           * x[3 * F + k * F + f]
                                           + x[F + f] * w[F + f] * dirs[s, k])
                if run >= 0:
                    put(run, acc)
                    nxt = run + 1
                for r in range(nxt, r1):
                    put(r, np.zeros((4, len(f))))
    return out, n_out


def _split_or_exact(a, b, exact):
    """The 3xTF32 model's factors and ``mma`` step, or (``exact``) the
    factors whole, zero remainders and a float64 step: the same k-steps
    with exact products."""
    if not exact:
        return (*_split(a, b), mma)
    return (a, b, torch.zeros_like(a), torch.zeros_like(b),
            lambda c, x, y: c + x @ y)


def _p3_3xtf32(gw, fwt, NW, exact=False):
    """grbf = gw [16, 3NT] fwt [3NT, N] as the backward's P3 forms it: warp
    w takes the k-steps w, w + NW, ... of 3NT into three accumulators that
    the tensor cores carry (the big product and the two cross terms of
    3xTF32), its slice big + (c1 + c2), the slices added in warp order;
    where N has at least NW n8-tiles (``gb_slices``) each warp takes whole
    n-tiles over every k-step (a column of the product does not depend on
    the others), its accumulators carrying 12 k-steps at a time (a k-split
    warp's share), added in order to the one slice.  ``exact``: the same
    steps in float64."""
    ab, bb, a_s, b_s, step = _split_or_exact(gw, fwt, exact)
    ks = gw.shape[1] // 8
    if fwt.shape[1] // 8 >= NW:
        groups = [range(k0, min(ks, k0 + 12)) for k0 in range(0, ks, 12)]
    else:
        groups = [range(w, ks, NW) for w in range(NW)]
    total = torch.zeros(gw.shape[0], fwt.shape[1], dtype=gw.dtype)
    for steps in groups:
        big, c1, c2 = (torch.zeros_like(total) for _ in range(3))
        for kk in steps:
            k = slice(8 * kk, 8 * kk + 8)
            c1 = step(c1, a_s[:, k], bb[k])
            c2 = step(c2, ab[:, k], b_s[k])
            big = step(big, ab[:, k], bb[k])
        total = total + (big + (c1 + c2))
    return total


def _gfw_3xtf32(rbf, gw, exact=False):
    """A chunk's gFW = rbf [16, B+1]^T gw [16, 3NT] as the wgrad instance
    forms it: two k-steps of 8 slots into three carried accumulators, their
    sum big + (c1 + c2) in float64.  ``exact``: the same steps in
    float64."""
    ab, bb, a_s, b_s, step = _split_or_exact(rbf.t().contiguous(), gw,
                                             exact)
    big, c1, c2 = (torch.zeros(rbf.shape[1], gw.shape[1], dtype=gw.dtype)
                   for _ in range(3))
    for k in (slice(0, 8), slice(8, 16)):
        c1 = step(c1, a_s[:, k], bb[k])
        c2 = step(c2, ab[:, k], b_s[k])
        big = step(big, ab[:, k], bb[k])
    return big.double() + (c1.double() + c2.double())


def _gen_bwd_walk(refs, xmu, rbf, dirs, FW, g_dq, g_dmu, G, E=16,
                  exact=False):
    """``msg_bwd_gen_kernel`` in its geometry-cotangent form (K15/K21) and
    its wgrad instance, in f32 with its products in the 3xTF32 model
    (``exact``: in float64 with exact products, the schedule, padding and
    chunking alone):
    block (column, range, tile) walks its source rows' slots in chunks of
    E on FW_aug padded to the feature tiles (``pad_gen_fw``; the lanes past
    F load zeros); per slot and feature of the tile the filter, the run
    sums of the open source row's dx and dmu in slot order, the filter
    cotangent gW and the dir cotangent's warp sums; per chunk grbf = gW
    FW^T as P3 forms it (``_p3_3xtf32``) and gFW's chunk sum
    (``_gfw_3xtf32``) added to the block's float64 partial; each tile's
    grbf and gdir a partial, summed after.  Returns (dxmu, grbf, gdir,
    gFW) and how often each element of dxmu was written."""
    dt = torch.float64 if exact else torch.float32
    xmu, rbf, dirs, FW, g_dq, g_dmu = (
        torch.tensor(a, dtype=dt) for a in (xmu, rbf, dirs, FW, g_dq, g_dmu))
    nx, ny, Ktot = refs.qcol.shape
    P, B1, F = refs.P, FW.shape[0], FW.shape[1] // 3
    Z, NT = msg.gen_tiles(F), msg.gen_threads(F)
    FWp = msg.pad_gen_fw(FW)                       # [B1, Z, 3, NT]
    NP = -(-B1 // 8) * 8
    esorted, grp = (a.numpy() for a in source_schedule(refs, G))
    qcol = refs.qcol.reshape(-1).numpy()
    dst = (decode_i(refs)[0]).reshape(-1).numpy()
    rbf, dirs = rbf.reshape(-1, B1), dirs.reshape(-1, 3)
    dxmu = torch.zeros_like(xmu)
    n_out = np.zeros(dxmu.shape, np.int64)
    grbf, gdir = torch.zeros_like(rbf), torch.zeros_like(dirs)
    gFW = torch.zeros(B1, Z, 3, NT, dtype=torch.float64)
    for z in range(Z):
        f = torch.arange(z * NT, z * NT + NT)
        real = f < F
        fr = f.clamp(max=F - 1)
        W = FWp[:, z].reshape(B1, 3 * NT)
        Wt = torch.zeros(3 * NT, NP, dtype=dt)
        Wt[:, :B1] = W.t()

        def feats(row, parts):   # the tile's features of `parts`, 0 past F
            return [torch.where(real, row[k * F + fr], 0.0) for k in parts]

        for col in range(nx * ny):
            for g in range(G):
                (r0, e0), (r1, e1) = grp[col, g], grp[col, g + 1]
                run, nxt = -1, r0
                acc = torch.zeros(6, NT, dtype=dt)
                cols = np.concatenate([f[real].numpy() + k * F
                                       for k in range(6)])

                def put(r, v):
                    dxmu[col * P + r, cols] = v[:, real].reshape(-1)
                    n_out[col * P + r, cols] += 1

                part = torch.zeros(B1, 3 * NT, dtype=torch.float64)
                for base in range(e0, e1, E):
                    slots = esorted[base:min(base + E, e1)]
                    gw = torch.zeros(E, 3 * NT, dtype=dt)
                    for t, s in enumerate(slots):
                        sv = qcol[s]
                        if sv != run:
                            if run >= 0:
                                put(run, acc)
                                nxt = run + 1
                            for r in range(nxt, sv):
                                put(r, torch.zeros(6, NT, dtype=dt))
                            run, nxt, acc = sv, sv, torch.zeros(6, NT,
                                                                dtype=dt)
                        xq, xr, xm, m0, m1, m2 = feats(xmu[col * P + sv],
                                                       range(6))
                        w = rbf[s] @ W
                        wq, wr, wm = w[:NT], w[NT:2 * NT], w[2 * NT:]
                        (gq,) = feats(g_dq[dst[s]], [0])
                        gm = feats(g_dmu[dst[s]], range(3))
                        gp1 = gm[0] * dirs[s, 0] + gm[1] * dirs[s, 1] \
                            + gm[2] * dirs[s, 2]
                        gp2 = gm[0] * m0 + gm[1] * m1 + gm[2] * m2
                        acc[0] += gq * wq
                        acc[1] += gp1 * wr
                        acc[2] += gp2 * wm
                        for k in range(3):
                            acc[3 + k] += gm[k] * (xm * wm)
                        gw[t] = torch.cat([gq * xq, gp1 * xr, gp2 * xm])
                        for k in range(3):   # the warps' sums, in order
                            gdir[s, k] += (gm[k] * (xr * wr)).view(
                                -1, 32).sum(1).sum()
                    n = len(slots)
                    grbf[slots] += _p3_3xtf32(gw, Wt, NT // 32,
                                              exact)[:n, :B1]
                    rb = torch.zeros(E, B1, dtype=dt)
                    rb[:n] = rbf[slots]
                    part += _gfw_3xtf32(rb, gw, exact)
                if run >= 0:
                    put(run, acc)
                    nxt = run + 1
                for r in range(nxt, r1):
                    put(r, torch.zeros(6, NT, dtype=dt))
                gFW[:, z] += part.view(B1, 3, NT)
    gFW = gFW.transpose(1, 2).reshape(B1, 3, Z * NT)[:, :, :F]
    shape = refs.qcol.shape
    return (dxmu.numpy(), grbf.reshape(*shape, B1).numpy(),
            gdir.reshape(*shape, 3).numpy(),
            gFW.reshape(B1, 3 * F).to(dt).numpy(), n_out)


#: float64 walks against float64 JAX: only the summation orders differ
GEN_RTOL, GEN_ATOL = 1e-10, 1e-12


@pytest.mark.parametrize("F,B,G", [(30, 12, 3), (288, 12, 2)])
def test_general_destination_walk_matches_jax(F, B, G):
    """The general forward's walk at F = 30 (one tile of 32 lanes, two
    past F) and 288 (two tiles of 160 lanes) matches the JAX package's
    ``_painn_message_xla`` in float64; every element of dq and dmu is
    written exactly once, rows with no slot are 0."""
    c, refs, xmu, rbf, dirs, FW, _, _ = _gen_inputs(F, B, seed=F)
    got, n_out = _gen_fwd_walk(refs, xmu, rbf, dirs, FW, G)
    assert bool((n_out == 1).all())
    jrefs = jcb.ColRefs.from_layout(c["lay"])
    want = _jax64(lambda *a: jcb._painn_message_xla(*a, jrefs), xmu, rbf,
                  dirs, FW)
    np.testing.assert_allclose(got, np.concatenate(want, 1), GEN_RTOL,
                               GEN_ATOL)
    assert msg.gen_tiles(F) == len(_tiles(F)) and sum(map(len, _tiles(F))) == F


@pytest.mark.parametrize("F,B,G", [(30, 12, 3), (288, 12, 2), (30, 50, 3),
                                   (130, 20, 2), (64, 40, 2), (30, 31, 2),
                                   (50, 20, 2), (512, 300, 2)])
def test_general_source_walk_matches_jax(F, B, G):
    """The general backward's walk (its geometry-cotangent form and its
    wgrad instance) at each switch of its design: F = 30 (one warp, two
    lanes past F), 50 (two warps, 14 lanes past F), 64 (the tuned width,
    whose wgrad instance at B+1 = 41 is general: three m16 tiles of gFW),
    130 (five warps, 30 lanes past F), 288 (two tiles of 160 lanes) and
    512 (two tiles of 256), B+1 = 13, 21, 32, 41, 51 and 301; the warps
    split P3's k-steps (F = 130 and 288) or, at F = 50 and 64 and at B+1 =
    301, its n-tiles (``gb_slices``).  Replayed with every product in
    float64 (the schedule, padding and chunking alone) it matches the VJP
    of the JAX package's ``_painn_message_xla`` in float64 to 1e-10;
    replayed in the kernel's arithmetic, dxmu, grbf and gdir (the tiles'
    partials summed) match it at the message tolerance or, where the f32
    VJP itself misses it, within twice its miss (the card's ``held``), gFW
    normwise to 1e-5 (the blocks' own partials).  Every element of dxmu
    is written exactly once."""
    c, refs, xmu, rbf, dirs, FW, g_dq, g_dmu = _gen_inputs(F, B, seed=F + B)
    *got, n_out = _gen_bwd_walk(refs, xmu, rbf, dirs, FW, g_dq, g_dmu, G)
    *got64, _ = _gen_bwd_walk(refs, xmu, rbf, dirs, FW, g_dq, g_dmu, G,
                              exact=True)
    assert bool((n_out == 1).all())
    jrefs = jcb.ColRefs.from_layout(c["lay"])

    def vjp(xmu, rbf, dirs, FW, g_dq, g_dmu):
        _, back = jax.vjp(lambda *a: jcb._painn_message_xla(*a, jrefs), xmu,
                          rbf, dirs, FW)
        return back((g_dq, g_dmu))

    args = (xmu, rbf, dirs, FW, g_dq, g_dmu)
    want = _jax64(vjp, *args)
    want32 = jax.tree.map(np.asarray, vjp(*[
        jnp.asarray(a, jnp.float32) for a in args]))
    real = (refs.qcol >= 0).numpy()
    for name, a, a64, w32, w in zip(("dxmu", "grbf", "gdir", "gFW"), got,
                                    got64, want32, want):
        if name in ("grbf", "gdir"):   # the kernels write real slots only
            a, a64, w32, w = a[real], a64[real], w32[real], w[real]
        np.testing.assert_allclose(a64, w, GEN_RTOL, GEN_ATOL,
                                   err_msg=f"{name} float64")
        if name == "gFW":
            err = np.linalg.norm(a - w)
            assert err <= 1e-5 * np.linalg.norm(w), (name, err)
            continue
        own = float(np.abs(w32 - w).max())
        if own <= MSG_ATOL:
            np.testing.assert_allclose(a, w, MSG_RTOL, MSG_ATOL, err_msg=name)
        else:
            assert float(np.abs(a - w).max()) <= 2 * own, (name, own)
