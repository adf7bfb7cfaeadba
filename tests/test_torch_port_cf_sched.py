"""PyTorch port: K9's and K10's schedules and arithmetic on the CPU.

K9, the cfconv (``csrc/schnet_columns.cu::cf_fwd_kernel``), runs on the
message forward's destination schedule (``colblock.destination_schedule``):
block (column, g) owns a range of the column's destination rows and walks
their slots in chunks of ``SLOTS``; its two filter products run in 3xTF32
on the tensor cores, and the fold sums each destination row's messages in
slot order.  K10, the cfconv VJP (``cf_bwd_kernel``), runs on the
message backward's source schedule (``colblock.source_schedule``): block
(column, g) owns a range of the column's source rows and walks their
slots in chunks of ``SLOTS``; its four filter products run in 3xTF32 on
the tensor cores, and the fold sums each source row's ghj in slot
order.  The kernels run only on the card; here plain walks over the
schedules in the kernels' order, with the products in the 3xTF32 model
of ``test_torch_port_mixing.py`` (``mm_3xtf32``: one ``mma.sync`` step at
a time, a fresh fragment per k-step), are held to the twins
(``cf_fwd_plain``, ``cf_bwd_plain``) and to the JAX package's
``_cfconv_xla`` and its VJP on the same numpy inputs, both in float64, at
the message tolerance (f32 sums in another order), with every output row
and every real slot of ggeo written exactly once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu.ops import colblock as jcb
from schnetpack_tpu.ops import colblock_geo as jgeo
from schnetpack_tpu.ops.schnet_columns import _cfconv_xla
from schnetpack_tpu_torch.ops import schnet_columns as cf
from schnetpack_tpu_torch.ops.colblock import (
    ColRefs, decode_j, destination_schedule, source_schedule,
)
from test_torch_port_mixing import mm_3xtf32, mm_3xtf32_comp
from torch_port_cases import MSG_ATOL, MSG_RTOL, cfconv_case

NAMES = ("h", "geo", "W1", "b1", "W2", "b2")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(F, B, seed, empty_col=0):
    """``cfconv_case`` on its 3 x 3 grid with every slot whose source or
    destination lies in column ``empty_col`` made a padded slot (its
    geometry zeroed), so that one column has no real slot on either
    side."""
    c = cfconv_case(F=F, B=B, seed=seed, n=110, L=11.0)
    lay = c["lay"]
    refs = ColRefs.from_layout(lay)
    nx, ny, Ktot = refs.qcol.shape
    j, _ = decode_j(refs)
    dest = torch.arange(nx * ny).view(nx, ny, 1).expand(nx, ny, Ktot)
    drop = ((j // refs.P == empty_col) | (dest == empty_col)).numpy()
    c["qcol"] = np.where(drop, -1, lay.qcol).astype(np.int32)
    c["dcol"] = np.where(drop, -1, lay.dcol).astype(np.int32)
    c["geo"] = c["geo"] * (c["qcol"] >= 0)[:, :, None, :]
    return c


def _refs(c):
    P, ksizes = c["lay"].dims[2], tuple(int(k) for k in c["lay"].dims[3])
    return ColRefs(torch.tensor(c["qcol"]), torch.tensor(c["dcol"]), int(P),
                   ksizes)


def _walk(c, G, E=cf.SLOTS, gen=False, wide=False, exact=False):
    """K10's outputs in its order: the slots in the source order of
    ``source_schedule(refs, G)``, block by block and chunk by chunk of E;
    per slot z1 = [phi | 1] W1p (W1 padded with zero rows to Bp), pre =
    ssp(z1 + b1) W2 + b2, gh1 = gpre W2^T and gphi = gz1 W1p^T in 3xTF32;
    ghj folded per source row in slot order in f32; wgrad: per chunk
    h1^T gpre and [phi | 1]^T gz1 in 3xTF32 (k-steps over the chunk's
    slots, zero-padded to E) added to the block's f32 sums, gb2 per
    feature over the two row phases, the blocks' sums added in float64.
    ``gen``: the general instance (``cf_bwd_gen_kernel``): F zero-padded
    to Fp (``gen_padded_weights``; h and g read as 0 past F), the four
    filter products with Kahan-compensated sums in its ``wide`` instance
    (kWide: the weights read from L2, where they do not fit shared
    memory), gfcut from Fp / 32 warp partials, gb2 per feature as each
    chunk's sum in slot order added to the range's.  ``exact``: the same
    walk in float64, every product exact: the schedule, padding and
    chunking alone.
    Returns (dh, ggeo, gW1, gb1, gW2, gb2, counts): how many times each
    dh row and each ggeo element was written, and the runs that cross a
    chunk bound."""
    dt = torch.float64 if exact else torch.float32
    refs = _refs(c)
    h, geo, W1, b1, W2, b2 = (torch.tensor(c[k]).to(dt) for k in NAMES)
    g = torch.tensor(c["g"]).to(dt)
    B, F0 = W1.shape
    nx, ny, Ktot = refs.qcol.shape
    P, nch = refs.P, B + 4
    Bp = cf._bp(B)
    if gen:
        W1p, b1, W2, b2 = cf.pad_gen_weights(W1, b1, W2, b2)
        F = W2.shape[0]
        h, g = (torch.nn.functional.pad(t, (0, F - F0)) for t in (h, g))
        mm = mm_3xtf32_comp if wide else mm_3xtf32
    else:
        F = F0
        W1p = torch.zeros(Bp, F)
        W1p[:B] = W1
        mm = mm_3xtf32
    mm_w = torch.matmul if exact else mm_3xtf32   # the wgrad products
    if exact:
        mm = torch.matmul
    esorted, grp = source_schedule(refs, G)
    qcol, dcol = refs.qcol.reshape(-1).long(), refs.dcol.reshape(-1).long()
    n_real = int((qcol >= 0).sum())
    s = esorted[:n_real].long()
    dc, k = s // Ktot, s % Ktot
    geo_c = geo.reshape(nx * ny, nch, Ktot)
    phi = torch.zeros(n_real, Bp, dtype=dt)
    phi[:, :B] = geo_c[dc, :B, k]
    phi[:, B] = 1.0
    fc = geo_c[dc, B, k]
    # the products of every slot (a row's result does not depend on the
    # other rows of its chunk)
    z1 = mm(phi, W1p) + b1
    h1, sg = cf.shifted_softplus(z1), torch.sigmoid(z1)
    pre = mm(h1, W2) + b2
    gm = g[dc * P + dcol[s]]
    src_col = torch.div(decode_j(refs)[0].reshape(-1)[s], P,
                        rounding_mode="floor")
    hj = h[src_col * P + qcol[s]]
    ghj = gm * pre * fc[:, None]
    gw = gm * hj
    gp = gw * fc[:, None]
    # gfcut: each warp's 32 features, then the kQ partials in order
    gfc = (gw * pre).view(n_real, F // 32, 32).sum(-1)
    gfc = sum(gfc[:, q] for q in range(F // 32))
    gz1 = mm(gp, W2.t().contiguous()) * sg
    gphi = mm(gz1, W1p.t().contiguous())[:, :B]

    dh = torch.zeros(nx * ny * P, F, dtype=dt)
    ggeo = torch.zeros(nx * ny, nch, Ktot, dtype=dt)
    n_dh = torch.zeros(nx * ny * P, dtype=torch.int64)
    n_gg = torch.zeros(nx * ny, nch, Ktot, dtype=torch.int64)
    # the padded slots of each destination column (block (col, 0))
    pad = (qcol < 0).view(nx * ny, Ktot)
    n_gg += pad[:, None, :]
    # every real slot: gphi, gfcut and 0 in the dir channels
    ggeo[dc, :B, k] = gphi
    ggeo[dc, B, k] = gfc
    n_gg[dc, :, k] += 1
    w64 = torch.zeros((B + 2) * F + F * F, dtype=torch.float64)
    crossing = 0
    for col in range(nx * ny):
        for gr in range(G):
            (r0, e0), (r1, e1) = grp[col, gr:gr + 2].tolist()
            run, nxt = -1, r0
            acc = torch.zeros(F, dtype=dt)
            gw2 = torch.zeros(F, F, dtype=dt)
            gw1 = torch.zeros(Bp, F, dtype=dt)
            gb2 = torch.zeros(1 if gen else 2, F, dtype=dt)
            for base in range(e0, e1, E):
                rows = list(range(base, min(base + E, e1)))
                if base > e0 and qcol[s[rows[0]]] == qcol[s[rows[0] - 1]]:
                    crossing += 1
                for e in rows:
                    q = int(qcol[s[e]])
                    assert src_col[e] == col and r0 <= q < r1
                    if q != run:
                        if run >= 0:
                            dh[col * P + run] = acc
                            n_dh[col * P + run] += 1
                            nxt = run + 1
                        n_dh[col * P + nxt:col * P + q] += 1
                        nxt, run = q, q
                        acc = torch.zeros(F, dtype=dt)
                    acc = acc + ghj[e]
                m = len(rows)
                pad_rows = (0, 0, 0, E - m)
                hc = torch.nn.functional.pad(h1[rows], pad_rows)
                gpc = torch.nn.functional.pad(gp[rows], pad_rows)
                phc = torch.nn.functional.pad(phi[rows], pad_rows)
                gzc = torch.nn.functional.pad(gz1[rows], pad_rows)
                gw2 = gw2 + mm_w(hc.t().contiguous(), gpc)
                gw1 = gw1 + mm_w(phc.t().contiguous(), gzc)
                if gen:   # the chunk's sum in slot order, then the range's
                    part = torch.zeros(F, dtype=dt)
                    for e in range(m):
                        part = part + gp[rows[e]]
                    gb2[0] = gb2[0] + part
                for ph in range(0 if gen else 2):
                    for e in range(ph, m, 2):
                        gb2[ph] = gb2[ph] + gp[rows[e]]
            if run >= 0:
                dh[col * P + run] = acc
                n_dh[col * P + run] += 1
                nxt = run + 1
            n_dh[col * P + nxt:col * P + r1] += 1
            w64 += torch.cat([gw1[:B + 1].reshape(-1), gw2.reshape(-1),
                              gb2.sum(0)]).double()
    w = w64.to(dt)
    gW1, gb1 = w[:B * F].view(B, F), w[B * F:(B + 1) * F]
    gW2 = w[(B + 1) * F:(B + 1) * F + F * F].view(F, F)
    gb2 = w[(B + 1) * F + F * F:]
    return (dh[:, :F0], ggeo.view(nx, ny, nch, Ktot), gW1[:, :F0],
            gb1[:F0], gW2[:F0, :F0], gb2[:F0], (n_dh, n_gg, crossing))


def _jax_vjp64(c):
    """The VJP of the JAX package's ``_cfconv_xla`` on float64 copies of
    the case's inputs (x64 enabled for this call only), rounded to f32."""
    P, ksizes = c["lay"].dims[2], tuple(int(k) for k in c["lay"].dims[3])
    with jax.enable_x64(True):
        refs = jcb.ColRefs(jnp.asarray(c["qcol"]), jnp.asarray(c["dcol"]), P,
                           ksizes)
        f64 = [jnp.asarray(c[k], jnp.float64) for k in NAMES + ("g",)]
        geo = jgeo.split_geo(f64[1], refs.ksizes)
        grads = jax.jit(lambda g, *a: jax.vjp(
            lambda *x: _cfconv_xla(*x, refs), *a)[1](g))(
                f64[6], f64[0], geo, *f64[2:6])
        assert grads[0].dtype == jnp.float64
        out = [grads[0], jgeo.concat_geo(grads[1])] + list(grads[2:])
        return [np.asarray(x).astype(np.float32) for x in out]


@pytest.mark.parametrize("F,B,seed,G", [(32, 8, 21, 3), (128, 20, 3, 4)])
def test_source_walk_matches_twin_and_jax(F, B, seed, G):
    """The walk's dh, ggeo and filter-weight cotangents match the twin and
    the JAX VJP, both evaluated in float64: at F = 128 the f32 twin itself
    misses its float64 result by 1.2x the tolerance on this case (gfcut, a
    128-long sum that cancels), the walk by at most 0.65x.  Each source
    row of dh and each element of ggeo is written once; a run crosses a
    chunk bound, block bounds fall inside columns, and column 0 has no
    real slot."""
    c = _case(F, B, seed)
    refs = _refs(c)
    *got, (n_dh, n_gg, crossing) = _walk(c, G)
    assert bool((n_dh == 1).all()) and bool((n_gg == 1).all())
    assert crossing > 0
    esorted, grp = source_schedule(refs, G)
    inner = grp[:, 1:-1, 0]
    assert bool(((inner > 0) & (inner < refs.P)).any())
    assert bool((refs.qcol.view(-1, refs.qcol.shape[-1])[0] < 0).all())
    assert int(grp[0, -1, 1] - grp[0, 0, 1]) == 0
    t = [torch.tensor(c[k]).double() for k in NAMES]
    twin = cf.cf_bwd_plain(*t, refs, torch.tensor(c["g"]).double())
    for name, a, w, j in zip(("dh", "ggeo", "gW1", "gb1", "gW2", "gb2"),
                             got, twin, _jax_vjp64(c)):
        np.testing.assert_allclose(a.numpy(), w.float().numpy(), MSG_RTOL,
                                   MSG_ATOL, err_msg=f"{name} vs twin")
        np.testing.assert_allclose(a.numpy(), j, MSG_RTOL, MSG_ATOL,
                                   err_msg=f"{name} vs jax")
    # zeros in the dir channels and at the padded slots
    gg = got[1].numpy()
    np.testing.assert_array_equal(gg[:, :, B + 1:], 0.0)
    np.testing.assert_array_equal(
        np.moveaxis(gg, 2, 3)[(refs.qcol < 0).numpy()], 0.0)


def _fwd_walk(c, G, E=cf.SLOTS, gen=False, wide=False, exact=False):
    """K9's output in its order: the slots in the destination order of
    ``destination_schedule(refs, G)``, block by block and chunk by chunk
    of E; per slot z1 = [phi | 1] W1p (W1 padded with zero rows to Bp)
    and pre = ssp(z1 + b1) W2 + b2 in 3xTF32, the message h_j (pre fcut),
    each destination row's messages summed in slot order in f32.  ``gen``:
    the general instance (``cf_fwd_gen_kernel``): F zero-padded to Fp
    (``pad_gen_weights``; h read as 0 past F), the products with Kahan-
    compensated sums in its ``wide`` instance (kWide: the weights read
    from L2, where they do not fit shared memory); every padded lane's
    message an exact 0, and each range's slots with fcut = 0 (exact
    zeros) dropped before the chunks are cut.
    ``exact``: the same walk in float64, every product exact: the
    schedule, padding and chunking alone.  Returns (out, how many times
    each row was written, the runs that cross a chunk bound)."""
    dt = torch.float64 if exact else torch.float32
    refs = _refs(c)
    h, geo, W1, b1, W2, b2 = (torch.tensor(c[k]).to(dt) for k in NAMES)
    B, F0 = W1.shape
    nx, ny, Ktot = refs.qcol.shape
    P, nch = refs.P, B + 4
    if gen:
        W1p, b1, W2, b2 = cf.pad_gen_weights(W1, b1, W2, b2)
        h = torch.nn.functional.pad(h, (0, W2.shape[0] - F0))
    else:
        W1p = W1.new_zeros(cf._bp(B), F0)
        W1p[:B] = W1
    F = W2.shape[0]
    mm = (torch.matmul if exact else mm_3xtf32_comp if gen and wide
          else mm_3xtf32)
    dsorted, grp = destination_schedule(refs, G)
    dcol = refs.dcol.reshape(-1).long()
    n_real = int((refs.qcol >= 0).sum())
    s = dsorted[:n_real].long()
    dc, k = s // Ktot, s % Ktot
    geo_c = geo.reshape(nx * ny, nch, Ktot)
    phi = torch.zeros(n_real, W1p.shape[0], dtype=dt)
    phi[:, :B] = geo_c[dc, :B, k]
    phi[:, B] = 1.0
    fc = geo_c[dc, B, k]
    h1 = cf.shifted_softplus(mm(phi, W1p) + b1)
    pre = mm(h1, W2) + b2
    msg = h[decode_j(refs)[0].reshape(-1)[s]] * (pre * fc[:, None])
    assert not msg[:, F0:].any()

    out = torch.zeros(nx * ny * P, F, dtype=dt)
    n_out = torch.zeros(nx * ny * P, dtype=torch.int64)
    crossing = 0
    for col in range(nx * ny):
        for gr in range(G):
            (r0, e0), (r1, e1) = grp[col, gr:gr + 2].tolist()
            walk = [e for e in range(e0, e1) if not gen or fc[e] != 0]
            run, nxt = -1, r0
            acc = torch.zeros(F, dtype=dt)
            for base in range(0, len(walk), E):
                if base and dcol[s[walk[base]]] == dcol[s[walk[base - 1]]]:
                    crossing += 1
                for e in walk[base:base + E]:
                    d = int(dcol[s[e]])
                    assert dc[e] == col and r0 <= d < r1
                    if d != run:
                        if run >= 0:
                            out[col * P + run] = acc
                            n_out[col * P + run] += 1
                            nxt = run + 1
                        n_out[col * P + nxt:col * P + d] += 1
                        nxt, run = d, d
                        acc = torch.zeros(F, dtype=dt)
                    acc = acc + msg[e]
            if run >= 0:
                out[col * P + run] = acc
                n_out[col * P + run] += 1
                nxt = run + 1
            n_out[col * P + nxt:col * P + r1] += 1
    return out[:, :F0], n_out, crossing


def _jax_fwd64(c):
    """The JAX package's ``_cfconv_xla`` on float64 copies of the case's
    inputs (x64 enabled for this call only), rounded to f32."""
    P, ksizes = c["lay"].dims[2], tuple(int(k) for k in c["lay"].dims[3])
    with jax.enable_x64(True):
        refs = jcb.ColRefs(jnp.asarray(c["qcol"]), jnp.asarray(c["dcol"]), P,
                           ksizes)
        h, geo, *w = [jnp.asarray(c[k], jnp.float64) for k in NAMES]
        out = jax.jit(lambda *a: _cfconv_xla(*a, refs))(
            h, jgeo.split_geo(geo, refs.ksizes), *w)
        assert out.dtype == jnp.float64
        return np.asarray(out).astype(np.float32)


@pytest.mark.parametrize("F,B,seed,G", [(64, 8, 21, 3), (128, 20, 3, 4)])
def test_destination_walk_matches_twin_and_jax(F, B, seed, G):
    """K9's walk matches the twin and the JAX ``_cfconv_xla``, both
    evaluated in float64, on a 3 x 3 grid whose real slots hit all nine
    buckets.  Each output row of each range is written once, rows with no
    slot (column 0 has none, and the padding rows of every column) are 0,
    a run crosses a chunk bound and block bounds fall inside columns."""
    c = _case(F, B, seed)
    refs = _refs(c)
    got, n_out, crossing = _fwd_walk(c, G)
    assert bool((n_out == 1).all())
    assert crossing > 0
    _, grp = destination_schedule(refs, G)
    inner = grp[:, 1:-1, 0]
    assert bool(((inner > 0) & (inner < refs.P)).any())
    nx, ny, Ktot = refs.qcol.shape
    real = (refs.qcol >= 0).reshape(-1)
    c9 = sum((torch.arange(Ktot) >= o).long() for o in refs.koffs[1:9])
    assert set(c9.expand(nx * ny, Ktot).reshape(-1)[real].tolist()) == set(
        range(9))
    dest = (torch.arange(nx * ny).view(nx, ny, 1) * refs.P
            + refs.dcol.long()).reshape(-1)[real]
    empty = torch.ones(nx * ny * refs.P, dtype=torch.bool)
    empty[dest] = False
    assert bool(empty[:refs.P].all()) and int(empty[refs.P:].sum()) > 0
    np.testing.assert_array_equal(got[empty].numpy(), 0.0)
    t = [torch.tensor(c[k]).double() for k in NAMES]
    twin = cf.cf_fwd_plain(*t, refs).float()
    np.testing.assert_allclose(got.numpy(), twin.numpy(), MSG_RTOL, MSG_ATOL,
                               err_msg="out vs twin")
    np.testing.assert_allclose(got.numpy(), _jax_fwd64(c), MSG_RTOL,
                               MSG_ATOL, err_msg="out vs jax")


@pytest.mark.parametrize("F,ok", [(64, True), (128, True), (96, False),
                                  (256, False)])
def test_cfconv_kernels_take_their_widths(F, ok):
    """The wrappers' check (``check_width``, before any launch) takes every
    width: the tuned instances F = 64 and 128 (``ok``), the general ones
    any other F."""
    cf.check_width(F, 20)
    assert cf.tuned_width(F, 20) == ok


# ------------------------------------------- the general instances' walks
#: the weight cotangents against float64, normwise (the card tests'
#: ``W_NORM_RTOL``): sums over every edge of products of f32 factors
W_NORM_RTOL = 1e-5


def _held(a, w32, w64, name):
    """``a`` at the message tolerance of ``w64``, or, where the f32 twin
    ``w32`` itself misses it, within twice the twin's miss (the card
    tests' ``held``: two f32 summation orders)."""
    own = float(np.abs(w32 - w64).max())
    if own <= MSG_ATOL:
        np.testing.assert_allclose(a, w64, MSG_RTOL, MSG_ATOL, err_msg=name)
    else:
        miss = float(np.abs(a - w64).max())
        assert miss <= 2 * own, (name, miss, own)


#: the general walks' cases: (F, B, G, wide, fwd_wide), ``wide`` where
#: K10's wgrad instance reads its weights from L2 (its plan, ``cfg_plan``:
#: they do not fit shared memory beside the group), ``fwd_wide`` where K9
#: does (from Fp = 224 at B = 20: F = 200, 300, 1024; Fp = 192 under the
#: switch: F = 192); at (1024, 20) K10's wgrad group's tiles do not fit
#: either (the kScr instance: the same arithmetic on tiles in global
#: scratch).  The card tests hold the switches to the launchers' plans
#: (``test_cfconv_smem_mirror_matches_the_kernel``).
GEN_WALKS = [(30, 50, 3, False, False), (96, 300, 2, False, False),
             (30, 300, 2, False, False), (96, 50, 3, False, False),
             (30, 20, 3, False, False), (64, 300, 2, True, False),
             (200, 20, 2, True, True), (300, 32, 2, True, True),
             (1024, 20, 2, True, True), (192, 20, 2, False, False)]


@pytest.mark.parametrize("F,B,G,wide,fwd_wide", GEN_WALKS,
                         ids=["-".join(map(str, w[:4])) for w in GEN_WALKS])
def test_general_walks_match_jax(F, B, G, wide, fwd_wide):
    """The general K9 walk and the general K10 walk (wgrad) at each switch
    of their plans (``wide``, ``fwd_wide``): F = 30 (Fp = 32, two lanes
    past F, four groups a block), 64 and 96
    (two), 192 and 200 (Fp = 192 and 224: K9's weights in shared memory
    and from L2; a thread takes two features, one group a block), 300 (a
    thread takes up to three) and 1024, B = 20, 32 (Bp = 40), 50 and 300
    (K = Bp past the tuned B <= 32).  Replayed with every product in
    float64 (the schedule, padding and chunking alone) both match the
    float64 twins to 1e-7 (the summation orders differ, and past z1 = 20
    the twin's softplus is linear, slope 1 where the kernels' sigmoid gives
    1 - 2e-9); replayed in the kernels' arithmetic (their products in the
    3xTF32 model, compensated sums where the weights come from L2) they
    match the twins and the JAX package's ``_cfconv_xla`` and its VJP, both
    evaluated in float64, as the card holds the kernels: K9's output, dh
    and ggeo at the message tolerance or, where the f32 twin itself misses
    it, within twice its miss (``_held``), the weight cotangents normwise
    to 1e-5.  Both float64 walks match JAX in float64 at the message
    tolerance (its shifted softplus keeps an f32 rounding: 8e-6
    relative).  A third of the real slots have fcut = 0, as past the
    cutoff.  Every output row, dh row and real slot of ggeo is written
    exactly once, and K10's padded slots and dir channels are 0."""
    c = _case(F, B, seed=F + B)
    c["geo"][:, :, B, ::3] = 0.0   # slots past the cutoff: fcut = 0
    out, n_out, _ = _fwd_walk(c, G, gen=True, wide=fwd_wide)
    out64, _, _ = _fwd_walk(c, G, gen=True, exact=True)
    *bwd, (n_dh, n_gg, _) = _walk(c, G, gen=True, wide=wide)
    *bwd64, _ = _walk(c, G, gen=True, wide=wide, exact=True)
    assert bool((n_out == 1).all()) and bool((n_dh == 1).all())
    assert bool((n_gg == 1).all())
    P, ksizes = c["lay"].dims[2], tuple(int(k) for k in c["lay"].dims[3])
    with jax.enable_x64(True):
        refs = jcb.ColRefs(jnp.asarray(c["qcol"]), jnp.asarray(c["dcol"]), P,
                           ksizes)
        f64 = [jnp.asarray(c[k], jnp.float64) for k in NAMES + ("g",)]

        def fwd(h, geo, *w):
            return _cfconv_xla(h, jgeo.split_geo(geo, refs.ksizes), *w,
                               refs)

        want = [np.asarray(fwd(*f64[:6]))]
        grads = jax.vjp(fwd, *f64[:6])[1](f64[6])
        want += [np.asarray(x) for x in grads]
    t = [torch.tensor(c[k]).double() for k in NAMES]
    g64 = torch.tensor(c["g"]).double()
    twin = [cf.cf_fwd_plain(*t, _refs(c))] + list(
        cf.cf_bwd_plain(*t, _refs(c), g64))
    t32 = [x.float() for x in t]
    twin32 = [cf.cf_fwd_plain(*t32, _refs(c))] + list(
        cf.cf_bwd_plain(*t32, _refs(c), g64.float()))
    got = [x.numpy() for x in [out] + bwd]
    real = np.broadcast_to((c["qcol"] >= 0)[:, :, None, :], got[2].shape)
    np.testing.assert_allclose(out64.numpy(), twin[0].numpy(), 1e-7, 1e-9,
                               err_msg="out float64")
    np.testing.assert_allclose(out64.numpy(), want[0], MSG_RTOL, MSG_ATOL,
                               err_msg="out float64 vs jax")
    for ref, tag in ((twin[0].numpy(), "twin"), (want[0], "jax")):
        _held(got[0], twin32[0].double().numpy(), ref, f"out vs {tag}")
    np.testing.assert_array_equal(got[2][:, :, B + 1:], 0.0)
    np.testing.assert_array_equal(
        np.moveaxis(got[2], 2, 3)[(c["qcol"] < 0)], 0.0)
    keep = real[:, :, :B + 1]
    for name, a, a64, w32, w, j in zip(
            ("dh", "ggeo", "gW1", "gb1", "gW2", "gb2"), got[1:], bwd64,
            twin32[1:], twin[1:], want[1:]):
        a64, w32, w = a64.numpy(), w32.double().numpy(), w.numpy()
        if name == "ggeo":   # real slots' phi and fcut channels only
            a, a64, w32, w, j = (x[:, :, :B + 1][keep]
                                 for x in (a, a64, w32, w, j))
        np.testing.assert_allclose(a64, w, 1e-7, 1e-9,
                                   err_msg=f"{name} float64")
        np.testing.assert_allclose(a64, j, MSG_RTOL, MSG_ATOL,
                                   err_msg=f"{name} float64 vs jax")
        for ref, tag in ((w, "twin"), (j, "jax")):
            if name.startswith("g") and name != "ggeo":   # normwise
                err = np.linalg.norm(a - ref)
                assert err <= W_NORM_RTOL * np.linalg.norm(ref), (name, tag)
            else:
                _held(a, w32, ref, f"{name} vs {tag}")
