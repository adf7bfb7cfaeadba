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


def _gen_bwd_walk(refs, xmu, rbf, dirs, FW, g_dq, g_dmu, G, E=16):
    """``msg_bwd_gen_kernel`` in its geometry-cotangent form (K15/K21) and
    its wgrad instance, in float64: block (column, range, tile) walks its
    source rows' slots in chunks of E; per slot and feature of the tile
    the run sums of the open source row's dx and dmu, the filter
    cotangent gW and the dir cotangent's terms; per slot grbf = gW FW^T
    and gdir summed over the tile's features (each tile a partial, summed
    after), and gFW += rbf^T gW.  Returns (dxmu, grbf, gdir, gFW) and how
    often each element of dxmu was written."""
    nx, ny, Ktot = refs.qcol.shape
    P, B1, F = refs.P, FW.shape[0], FW.shape[1] // 3
    esorted, grp = (a.numpy() for a in source_schedule(refs, G))
    qcol = refs.qcol.reshape(-1).numpy()
    dst = (decode_i(refs)[0]).reshape(-1).numpy()
    rbf, dirs = rbf.reshape(-1, B1), dirs.reshape(-1, 3)
    dxmu = np.zeros_like(xmu)
    n_out = np.zeros(dxmu.shape, np.int64)
    grbf, gdir = np.zeros_like(rbf), np.zeros_like(dirs)
    gFW = np.zeros_like(FW)
    for col in range(nx * ny):
        for g in range(G):
            (r0, e0), (r1, e1) = grp[col, g], grp[col, g + 1]
            for f in _tiles(F):
                cols = np.concatenate([f + k * F for k in range(6)])
                run, nxt, acc = -1, r0, np.zeros((6, len(f)))

                def put(r, v):
                    dxmu[col * P + r, cols] = v.reshape(-1)
                    n_out[col * P + r, cols] += 1

                for base in range(e0, e1, E):
                    for s in esorted[base:min(base + E, e1)]:
                        sv = qcol[s]
                        if sv != run:
                            if run >= 0:
                                put(run, acc)
                                nxt = run + 1
                            for r in range(nxt, sv):
                                put(r, np.zeros((6, len(f))))
                            run, nxt, acc = sv, sv, np.zeros((6, len(f)))
                        x = xmu[col * P + sv]
                        xq, xr, xm = x[f], x[F + f], x[2 * F + f]
                        m = [x[3 * F + k * F + f] for k in range(3)]
                        w = rbf[s] @ FW
                        wq, wr, wm = w[f], w[F + f], w[2 * F + f]
                        gq = g_dq[dst[s], f]
                        gm = [g_dmu[dst[s], k * F + f] for k in range(3)]
                        gp1 = sum(gm[k] * dirs[s, k] for k in range(3))
                        gp2 = sum(gm[k] * m[k] for k in range(3))
                        acc[0] += gq * wq
                        acc[1] += gp1 * wr
                        acc[2] += gp2 * wm
                        for k in range(3):
                            acc[3 + k] += gm[k] * xm * wm
                        gw = np.concatenate([gq * xq, gp1 * xr, gp2 * xm])
                        fcols = np.concatenate([f, F + f, 2 * F + f])
                        grbf[s] += FW[:, fcols] @ gw
                        for k in range(3):
                            gdir[s, k] += (gm[k] * xr * wr).sum()
                        gFW[:, fcols] += np.outer(rbf[s], gw)
                if run >= 0:
                    put(run, acc)
                    nxt = run + 1
                for r in range(nxt, r1):
                    put(r, np.zeros((6, len(f))))
    shape = refs.qcol.shape
    return (dxmu, grbf.reshape(*shape, B1), gdir.reshape(*shape, 3), gFW,
            n_out)


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


@pytest.mark.parametrize("F,B,G", [(30, 12, 3), (288, 12, 2), (30, 50, 3)])
def test_general_source_walk_matches_jax(F, B, G):
    """The general backward's walk (its geometry-cotangent form and its
    wgrad instance, at B+1 = 13 and 51) matches the VJP of the JAX
    package's ``_painn_message_xla`` in float64: dxmu, grbf, gdir (the
    tiles' partials summed) and gFW (any B+1: the blocks' own partials);
    every element of dxmu is written exactly once."""
    c, refs, xmu, rbf, dirs, FW, g_dq, g_dmu = _gen_inputs(F, B, seed=F + B)
    *got, n_out = _gen_bwd_walk(refs, xmu, rbf, dirs, FW, g_dq, g_dmu, G)
    assert bool((n_out == 1).all())
    jrefs = jcb.ColRefs.from_layout(c["lay"])

    def vjp(xmu, rbf, dirs, FW, g_dq, g_dmu):
        _, back = jax.vjp(lambda *a: jcb._painn_message_xla(*a, jrefs), xmu,
                          rbf, dirs, FW)
        return back((g_dq, g_dmu))

    want = _jax64(vjp, xmu, rbf, dirs, FW, g_dq, g_dmu)
    real = (refs.qcol >= 0).numpy()
    for name, a, w in zip(("dxmu", "grbf", "gdir", "gFW"), got, want):
        if name in ("grbf", "gdir"):   # the kernels write real slots only
            a, w = a[real], w[real]
        np.testing.assert_allclose(a, w, GEN_RTOL, GEN_ATOL, err_msg=name)
