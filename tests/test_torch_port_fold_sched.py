"""PyTorch port: K14's and K8's schedules and arithmetic on the CPU.

K14, the per-destination fold (``csrc/colblock_select.cu::row_sum_kernel``,
the body K12 runs on the source order), sums each destination row's run
of slots in ``colblock.destination_order`` (the message forward's
destination order, with its row pointers) in slot order: one thread a
(row, lane), each output row written once, a row with no slot 0; at
D = 3 a group of ``ROW_LANES`` lanes a row (``row_sum_narrow_kernel``,
walked in ``torch_port_cases.narrow_row_sum_walk``).  K8, the
raw-phi geometry VJP (``csrc/colblock_geo.cu``), is two passes: (a) one
thread a real edge slot on K5's grid chains the slot's cotangent back to
its grij; (b) one thread a row adds the grij of its run in the source
order (``colblock.source_order``) and subtracts those of its run in the
destination order, each in slot order, and writes dR once.  The kernels
run only on the card; here plain walks in the kernels' order and f32
arithmetic are held to the twins (``fold_fwd_plain``, ``geo_bwd_plain``)
and to the JAX package's ``_column_fold_xla`` and the VJP of
``column_geometry_xla(..., raw_phi=True)`` on the same numpy inputs, at
the message tolerance (f32 sums in another order), on layouts with empty
rows, an empty column and padded slots, and at capacities P = 1,100 and
1,500 (above the 1,052 at which K8's per-column shared sums failed to
launch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu.ops import colblock as jcb
from schnetpack_tpu.ops import colblock_geo as jgeo
from schnetpack_tpu.ops.radial import gaussian_rbf_params
from schnetpack_tpu_torch.ops import colblock_geo as geo_op
from schnetpack_tpu_torch.ops import colblock_select as sel
from schnetpack_tpu_torch.ops.colblock import (
    ColRefs, decode_i, decode_j, destination_order, sorted_runs,
    source_order,
)
from schnetpack_tpu_torch.ops.radial import gaussian_rbf_table
from torch_port_cases import (
    MSG_ATOL, MSG_RTOL, message_case, narrow_row_sum_walk, wide_column_case,
)

#: threads of a K12/K14 block, and the cap on its grid (``spk_row_sums``)
ROW_THREADS, ROW_BLOCK_CAP = 128, 1 << 20
#: slots of a K8 (a) block, rows of a K8 (b) block (``spk_geo_bwd``)
SLOT_THREADS, GEO_ROW_THREADS = 128, 64
B, CUTOFF = 12, 3.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _emptied(seed, empty_col=0):
    """``message_case`` on its 3 x 3 grid with every slot whose source or
    destination lies in column ``empty_col`` made a padded slot, so that
    column has no real slot on either side; the rows past each column's
    atoms have none either."""
    c = message_case(B=B, cutoff=CUTOFF, seed=seed)
    lay = c["lay"]
    refs = ColRefs.from_layout(lay)
    nx, ny, Ktot = refs.qcol.shape
    j, _ = decode_j(refs)
    dest = torch.arange(nx * ny).view(nx, ny, 1).expand(nx, ny, Ktot)
    drop = ((j // refs.P == empty_col) | (dest == empty_col)).numpy()
    qcol = np.where(drop, -1, lay.qcol).astype(np.int32)
    dcol = np.where(drop, -1, lay.dcol).astype(np.int32)
    return dict(qcol=qcol, dcol=dcol, P=int(lay.dims[2]),
                ksizes=tuple(int(k) for k in lay.dims[3]), Rs=c["Rs"],
                coff_fm=c["coff_fm"])


CASES = {"emptied0": lambda: _emptied(0), "emptied3": lambda: _emptied(3),
         "P1100": lambda: wide_column_case(1100, 1),
         "P1500": lambda: wide_column_case(1500, 2)}


def _refs(c):
    return ColRefs(torch.tensor(c["qcol"]), torch.tensor(c["dcol"]), c["P"],
                   c["ksizes"])


def _run_sums(vals, order, rowptr):
    """Each row's sum of ``vals`` over its run order[rowptr[r]] ..
    order[rowptr[r+1] - 1], added in that order in the dtype of ``vals``
    (vectorized over the rows, one position of the run at a time).
    Returns the sums and how often each slot was read."""
    start = rowptr[:-1].long()
    length = (rowptr[1:] - rowptr[:-1]).long()
    out = torch.zeros(len(start), vals.shape[1], dtype=vals.dtype)
    reads = torch.zeros(vals.shape[0], dtype=torch.int64)
    for t in range(int(length.max()) if len(length) else 0):
        rows = (length > t).nonzero().squeeze(1)
        e = order[start[rows] + t].long()
        out[rows] += vals[e]
        reads.index_add_(0, e, torch.ones_like(e))
    return out, reads


def _row_sum_walk(vals, order, rowptr):
    """K12/K14 (``row_sum_kernel``) on edge values ``vals`` [E, D]: the
    grid-stride threads of ``spk_row_sums`` over (row, lane), each
    writing its (row, lane) once; at a narrow width (D < 8, D % 4 != 0)
    ``row_sum_narrow_kernel``'s lane groups, one lane writing each
    element.  Returns (out, reads per slot, writes per output
    element)."""
    A, D = len(rowptr) - 1, vals.shape[1]
    if D % 4 != 0 and D < 8:
        out, _, reads = narrow_row_sum_walk(vals, order, rowptr,
                                            sel.ROW_LANES)
        return out, reads, torch.ones((A, D), dtype=torch.int64)
    nvec = D // 4 if D % 4 == 0 else D
    total = A * nvec
    blocks = min(-(-total // ROW_THREADS), ROW_BLOCK_CAP)
    stride = blocks * ROW_THREADS
    writes = torch.zeros(total, dtype=torch.int64)
    for t0 in range(0, total, stride):
        writes[t0:t0 + stride] += 1
    out, reads = _run_sums(vals, order, rowptr)
    return out, reads, writes.view(A, nvec)


@pytest.mark.parametrize("name,D", [("emptied0", 3), ("emptied3", 9),
                                    ("emptied0", 64), ("P1100", 9)])
def test_fold_walk_matches_twin_and_jax(name, D):
    """K14's walk over ``destination_order``'s runs equals the twin and JAX's
    ``_column_fold_xla`` at the message tolerance; every output row is
    written once, every real slot read once and no padded slot read; rows
    without slots (column 0, rows past the atoms) are 0."""
    c = CASES[name]()
    refs = _refs(c)
    nx, ny, Ktot = refs.qcol.shape
    vals = np.random.RandomState(D).randn(nx, ny, Ktot, D).astype(np.float32)
    dsorted, _, rowptr = destination_order(refs)
    got, reads, writes = _row_sum_walk(torch.tensor(vals).view(-1, D),
                                       dsorted, rowptr)
    real = (refs.qcol >= 0).reshape(-1)
    assert bool((writes == 1).all())
    assert bool((reads[real] == 1).all()) and bool((reads[~real] == 0).all())
    empty = (rowptr[1:] == rowptr[:-1])
    assert bool(empty.any()) and bool((got[empty] == 0).all())
    if name.startswith("emptied"):     # column 0
        assert bool(empty[:refs.P].all())
    else:                              # the rows past each column's atoms
        assert bool(empty.view(-1, refs.P)[:, -7:].all())
    twin = sel.fold_fwd_plain(torch.tensor(vals), refs)
    jrefs = jcb.ColRefs(jnp.asarray(c["qcol"]), jnp.asarray(c["dcol"]),
                        c["P"], c["ksizes"])
    want = np.asarray(jcb._column_fold_xla(jnp.asarray(vals), jrefs))
    np.testing.assert_allclose(got.numpy(), twin.numpy(), MSG_RTOL, MSG_ATOL)
    np.testing.assert_allclose(got.numpy(), want, MSG_RTOL, MSG_ATOL)
    # the op on the CPU (the twin) is what the walk was held to
    torch.testing.assert_close(sel.column_fold_op(torch.tensor(vals), refs),
                               twin, rtol=0, atol=0)


def _slot_pass(c, g, cw):
    """K8 (a) in f32: per real slot of K5's grid (columns x slot tiles of
    ``SLOT_THREADS``), rij from the two position rows and the offset, d,
    dfcut, the Gaussians' chain and grij, as ``geo_bwd_slot_kernel``
    computes them.  Returns grij [nx * ny * Ktot, 3] (0 at padded slots,
    which the kernel leaves unwritten) and the writes per slot."""
    refs = _refs(c)
    nx, ny, Ktot = refs.qcol.shape
    R = torch.tensor(c["Rs"])
    j, valid = decode_j(refs)
    i, _ = decode_i(refs)
    valid = valid.reshape(-1)
    j, i = j.reshape(-1)[valid], i.reshape(-1)[valid]
    k_grid = torch.arange(-(-Ktot // SLOT_THREADS) * SLOT_THREADS)
    live = k_grid < Ktot                       # threads past Ktot return
    assert int(live.sum()) == Ktot
    off = torch.tensor(c["coff_fm"]).movedim(2, 3).reshape(-1, 3)[valid]
    r = R[j] + off - R[i]
    d = torch.sqrt((r * r).sum(1))
    assert float(d.min()) > 1e-3
    inv = 1.0 / d
    pi_rc = torch.tensor(np.float32(np.pi) / np.float32(CUTOFF))
    dfc = torch.where(d < CUTOFF, -0.5 * pi_rc * torch.sin(d * pi_rc),
                      torch.zeros_like(d))
    gs = torch.tensor(g).view(nx * ny, B + 4, Ktot).movedim(1, 2).reshape(
        -1, B + 4)[valid]
    gd = gs[:, B] * dfc
    for b in range(B):
        df = d - cw[b, 0]
        phi = torch.exp(cw[b, 1] * df * df)
        gd = gd + gs[:, b] * (2.0 * cw[b, 1] * df * phi)
    gdir = gs[:, B + 1:]
    gdr = (gdir * r).sum(1) * inv * inv * inv
    grij = torch.zeros(nx * ny * Ktot, 3)
    grij[valid] = (gdir * inv[:, None] - r * gdr[:, None]
                   + (gd * inv)[:, None] * r)
    return grij, valid.long()


def _geo_bwd_walk(c, g, cw):
    """K8's dR in its order: pass (a), then per row (``GEO_ROW_THREADS`` a
    block, one thread a row) its source run's grij summed in slot order
    less its destination run's.  Returns (dR, writes per slot in (a),
    reads per slot from the source end and from the destination end,
    writes per row)."""
    refs = _refs(c)
    grij, slot_writes = _slot_pass(c, g, cw)
    esorted, _, rowptr = source_order(refs)
    dsorted, _, rowptr_dst = destination_order(refs)
    src, src_reads = _run_sums(grij, esorted, rowptr)
    dst, dst_reads = _run_sums(grij, dsorted, rowptr_dst)
    A = len(rowptr) - 1
    threads = -(-A // GEO_ROW_THREADS) * GEO_ROW_THREADS
    row_writes = (torch.arange(threads) < A).long()[:A]
    return src - dst, (slot_writes, src_reads, dst_reads, row_writes)


def _jax_dR(c, g):
    """The VJP of the JAX package's raw-phi ``column_geometry_xla``."""
    jrefs = jcb.ColRefs(jnp.asarray(c["qcol"]), jnp.asarray(c["dcol"]),
                        c["P"], c["ksizes"])
    centers, widths = gaussian_rbf_params(B, CUTOFF, 0.0)

    def f(R):
        return jgeo.concat_geo(jgeo.column_geometry_xla(
            R, jnp.asarray(c["coff_fm"]), jrefs, centers, widths, CUTOFF,
            raw_phi=True))

    _, vjp = jax.vjp(f, jnp.asarray(c["Rs"]))
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("name", ["emptied0", "emptied3", "P1100", "P1500"])
def test_geo_bwd_walk_matches_twin_and_jax(name):
    """K8's two passes equal the twin and the JAX VJP at the message
    tolerance: each real slot's grij written once in (a) and read once
    from each end in (b), no padded slot touched, each dR row written
    once, rows with no slot 0; at P = 1,100 and 1,500 too, which K8's
    per-column [9][P][3] shared sums could not launch."""
    c = CASES[name]()
    refs = _refs(c)
    nx, ny, Ktot = refs.qcol.shape
    g = np.random.RandomState(len(name)).randn(
        nx, ny, B + 4, Ktot).astype(np.float32)
    cw = gaussian_rbf_table(B, CUTOFF)
    got, (slot_writes, src_reads, dst_reads, row_writes) = _geo_bwd_walk(
        c, g, cw)
    real = (refs.qcol >= 0).reshape(-1).long()
    for n in (slot_writes, src_reads, dst_reads):
        assert bool((n == real).all())
    assert bool((row_writes == 1).all()) and len(row_writes) == len(got)
    rowptr = destination_order(refs)[2]
    rowptr_src = source_order(refs)[2]
    empty = (rowptr[1:] == rowptr[:-1]) & (rowptr_src[1:] == rowptr_src[:-1])
    assert bool(empty.any()) and bool((got[empty] == 0).all())
    args = (torch.tensor(c["Rs"]), torch.tensor(c["coff_fm"]), refs, cw,
            CUTOFF)
    twin = geo_op.geo_bwd_plain(torch.tensor(g), *args)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), MSG_RTOL, MSG_ATOL)
    np.testing.assert_allclose(got.numpy(), _jax_dR(c, g), MSG_RTOL,
                               MSG_ATOL)
    # inside and beyond the cutoff both occur among the real slots
    geo = geo_op.geo_fwd_plain(*args, with_d=False, raw_phi=True)
    fcut = geo[:, :, B][refs.qcol >= 0]
    assert bool((fcut > 0).any()) and bool((fcut == 0).any())


@pytest.mark.parametrize("name", ["emptied0", "P1100"])
def test_destination_runs_are_each_rows_slots(name):
    """K14's and K8's destination runs: the row pointers of
    ``destination_order`` (the message forward's order), int32 from 0 to
    the real slots, the exclusive sums of its counts, slot e in the run of
    its destination row i(e) in slot order, all cached on the refs."""
    refs = _refs(CASES[name]())
    dsorted, cnt, rowptr = destination_order(refs)
    assert all(a is b for a, b in zip(destination_order(refs),
                                      (dsorted, cnt, rowptr)))
    assert torch.equal(rowptr[1:].long() - rowptr[:-1].long(), cnt)
    assert rowptr.dtype == torch.int32
    assert len(rowptr) == refs.qcol.shape[0] * refs.qcol.shape[1] * refs.P + 1
    i, valid = decode_i(refs)
    i, valid = i.reshape(-1).numpy(), valid.reshape(-1).numpy()
    ds, rp = dsorted.numpy(), rowptr.numpy()
    assert rp[0] == 0 and rp[-1] == valid.sum() == cnt.sum()
    for row in np.nonzero(np.diff(rp))[0]:
        run = ds[rp[row]:rp[row + 1]]
        assert valid[run].all() and (i[run] == row).all()
        assert (np.diff(run) > 0).all()


@pytest.mark.parametrize("n,slots,seed", [(1, 5, 0), (37, 400, 1),
                                          (500, 3000, 2), (64, 0, 3)])
def test_sorted_runs_match_a_count_and_cumsum(n, slots, seed):
    """``sorted_runs``, which both orders come from: the stable argsort of
    the keys (padded slots, key n, last), the slots per row as a bincount
    of the real keys and the row pointers as their exclusive cumulative
    sum, the dtypes the kernels read (int32), rows with no slot included."""
    rng = np.random.RandomState(seed)
    key = torch.tensor(rng.randint(0, n + 1, size=slots), dtype=torch.int64)
    key[key == n // 2] = n             # an empty row, padded slots
    order, cnt, rowptr = sorted_runs(key, n)
    assert order.dtype == cnt.dtype == rowptr.dtype == torch.int32
    assert torch.equal(order.long(), torch.argsort(key, stable=True))
    want = torch.bincount(key, minlength=n + 1)[:n]
    assert torch.equal(cnt.long(), want) and int(cnt[n // 2]) == 0
    assert torch.equal(rowptr.long(), torch.cat([want.new_zeros(1),
                                                 want.cumsum(0)]))
