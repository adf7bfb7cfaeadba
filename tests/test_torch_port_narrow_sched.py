"""PyTorch port: the narrow row sums of K12, K14 and K17, and K16's cell
index mode, on the CPU.

At a narrow width (D < 8, D % 4 != 0: the positions' D = 3) the row sums
(``csrc/colblock_select.cu::row_sum_narrow_kernel``, the body of K12 and
K17 on the source orders and of K14 on the destination order) give each
row a group of ``ROW_LANES`` lanes: lane l adds every ROW_LANES-th slot
of the row's run from the l-th, and the group adds its partials by a
butterfly of shuffles.  K16, the 27-cell gather, is the narrow select
kernel in a cell index mode: one thread a slot of a stack (the nz cells
of an (x, y), ``csrc/cellblock.cuh``) on a (slot tile, y, x) grid, which
decodes the slot's code (``CellStack::decode``) and wraps the bucket's
(dx, dy) onto the grid.  The kernels run only on the card; here a walk of
the row sums in their f32 order (``torch_port_cases.narrow_row_sum_walk``)
is held to the twins and to ``jax.vjp`` of the JAX package's
``_column_gather_xla`` and of the XLA branch of ``cell_gather`` on the
same numpy inputs, at the message tolerance (f32 sums in another order),
on a column layout, an aliased 2-cell layout and one with nz = 1; and the
grid's decode is replayed against ``decode_cell_j`` on grids of 1, 2 and
3 cells along each axis.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu.ops import cellblock as jcellblock
from schnetpack_tpu.ops import colblock as jcb
from schnetpack_tpu_torch.ops import cellblock_gather as cg
from schnetpack_tpu_torch.ops import colblock_select as sel
from schnetpack_tpu_torch.ops.colblock import ColRefs, source_order
from torch_port_cases import (
    MSG_ATOL, MSG_RTOL, cell_case, message_case, narrow_row_sum_walk,
)

#: slots of a narrow select block (``kNarrowThreads``)
NARROW_BLOCK = 256
#: the layouts of the walks: K12's column layout, and K17's 27-cell
#: layout on a 2-cell grid per axis (offsets alias) and with nz = 1
LAYOUTS = ("column", "cell_aliased", "cell_nz1")
#: pinned cell grids of the decode replay, 1, 2 and 3 cells per axis (in a
#: 13 A box, so every cell is at least the 3.4 A cutoff wide)
GRIDS = [(1, 2, 3), (2, 3, 1), (3, 1, 2), (2, 2, 1), (1, 1, 1), (3, 3, 3)]


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jcellblock, "IMPL", "xla")


def _layout(name):
    """(refs, n_slots, source table rows, the source order, the twin and
    the JAX gather of a table) of a walk's layout."""
    if name == "column":
        lay = message_case(seed=2)["lay"]
        refs = ColRefs.from_layout(lay)
        jrefs = jcb.ColRefs.from_layout(lay)
        esorted, _, rowptr = source_order(refs)
        return (refs, refs.qcol.numel(), refs.src_rows, esorted, rowptr,
                sel.gather_bwd_plain,
                lambda t: jcb._column_gather_xla(t, jrefs))
    c = cell_case(seed=5, dims=(2, 2, 1) if name == "cell_nz1" else None)
    refs = cg.CellRefs(torch.tensor(c["qidx"]))
    nx, ny, nz, C, K = refs.dims
    assert nz == 1 if name == "cell_nz1" else max(nx, ny, nz) == 2
    esorted, _, rowptr = cg.source_order(refs)
    qidx = jnp.asarray(c["qidx"])
    return (refs, refs.qidx.numel(), refs.n_rows, esorted, rowptr,
            cg.cell_gather_bwd_plain,
            lambda t: jcellblock.cell_gather(t, qidx))


@pytest.mark.parametrize("name,D,lanes", [
    *[(name, D, sel.ROW_LANES) for name in LAYOUTS for D in (1, 2, 3, 5)],
    ("cell_aliased", 3, 8), ("column", 5, 8)])
def test_narrow_row_sum_walk_matches_twin_and_jax(name, D, lanes):
    """The lane split and the shuffle butterfly in f32 equal the twin and
    the VJP of JAX's gather at the message tolerance, every lane of a
    group ends with the same sums bit for bit, every real slot is read
    once and no padded slot read, and rows with no slot are 0."""
    refs, n_slots, n_rows, esorted, rowptr, twin, jgather = _layout(name)
    rng = np.random.RandomState(D + lanes)
    g = rng.randn(n_slots, D).astype(np.float32)
    got, part, reads = narrow_row_sum_walk(torch.tensor(g), esorted, rowptr,
                                           lanes)
    assert got.shape == (n_rows, D)
    assert torch.equal(part, part[:, :1].expand_as(part))
    real = (refs.qcol if name == "column" else refs.qidx).reshape(-1) >= 0
    assert bool((reads[real] == 1).all()) and bool((reads[~real] == 0).all())
    empty = rowptr[1:] == rowptr[:-1]
    assert bool((got[empty] == 0).all())
    assert int((rowptr.diff() > lanes).sum()) > 0   # runs past one step
    edges = torch.tensor(g).view(*(refs.qcol.shape if name == "column"
                                   else (n_rows, -1)), D)
    np.testing.assert_allclose(got.numpy(), twin(edges, refs).numpy(),
                               MSG_RTOL, MSG_ATOL)
    table = jnp.asarray(rng.randn(n_rows, D).astype(np.float32))
    _, vjp = jax.vjp(jgather, table)
    (want,) = vjp(jnp.asarray(edges.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), MSG_RTOL,
                               MSG_ATOL)


@pytest.mark.parametrize("name", LAYOUTS[1:])
def test_cell_source_order_is_a_stable_sort(name):
    """The cell layout's source order (now ``colblock.sorted_runs``) is
    the stable argsort of the source rows, padded slots last, that K19's
    schedule walked before: not a slot of K19's order moves."""
    refs = _layout(name)[0]
    j, valid = cg.decode_cell_j(refs)
    key = torch.where(valid, j, refs.n_rows).reshape(-1)
    esorted, cnt, rowptr = cg.source_order(refs)
    assert torch.equal(esorted.long(), torch.argsort(key, stable=True))
    assert torch.equal(cnt, rowptr.diff())
    assert cg.stack_source_schedule(refs, 3)[0] is esorted


def _wrap(v, n):
    """The kernels' wrap by compare of v in [-n, 2n)."""
    return v + torch.where(v < 0, n, 0) - torch.where(v >= n, n, 0)


def narrow_cell_rows(refs):
    """K16's narrow select kernel, thread by thread: block (kt, y, x)'s
    thread t takes slot k = kt * 256 + t < Ktot' of stack (x, y) and, from
    its code q >= 0, ``CellStack::decode``'s bucket c9 = o / 3 and row sz*C
    + s of the source stack (sz the wrap of a / C + o % 3 - 1, a = k / K),
    the source stack the wrap of (x + c9/3 - 1, y + c9%3 - 1).  Returns the
    table row of every slot (-1 where padded) in slot order, and the
    threads that took each slot."""
    nx, ny, nz, C, K = refs.dims
    _, P, Kt = refs.stack
    kt = torch.arange(-(-Kt // NARROW_BLOCK))
    t = torch.arange(NARROW_BLOCK)
    x, y, kt, t = torch.meshgrid(torch.arange(nx), torch.arange(ny), kt, t,
                                 indexing="ij")
    k = kt * NARROW_BLOCK + t
    live = k < Kt
    x, y, k = x[live], y[live], k[live]
    slot = (x * ny + y) * Kt + k
    q = refs.qidx.reshape(-1).long()[slot]
    qc = q.clamp(min=0)
    o = qc // C
    s, a = qc - o * C, k // K
    sz = _wrap(a // C + o % 3 - 1, nz)
    c9 = o // 3
    col = _wrap(x + c9 // 3 - 1, nx) * ny + _wrap(y + c9 % 3 - 1, ny)
    rows = torch.full((refs.qidx.numel(),), -2, dtype=torch.int64)
    rows[slot] = torch.where(q >= 0, col * P + sz * C + s, -1)
    taken = torch.bincount(slot, minlength=refs.qidx.numel())
    return rows, taken


@pytest.mark.parametrize("dims", GRIDS)
def test_cell_mode_decode_replay_is_decode_cell_j(dims):
    """Every slot of a pinned grid is taken by one thread of the narrow
    grid, whose decode names the twins' source row (``decode_cell_j``),
    which is the layout's neighbor index: each offset wraps on its own, so
    aliased axes of one or two cells stay exact."""
    c = cell_case(seed=sum(dims), n=120, L=13.0, dims=dims)
    refs = cg.CellRefs(torch.tensor(c["qidx"]))
    assert refs.dims[:3] == dims
    rows, taken = narrow_cell_rows(refs)
    assert bool((taken == 1).all())
    j, valid = cg.decode_cell_j(refs)
    want = torch.where(valid, j, -1).reshape(-1)
    assert torch.equal(rows, want)
    lay = c["lay"]
    real = lay.nbh_mask > 0
    assert real.any()
    np.testing.assert_array_equal(rows.view(lay.nbh_idx.shape).numpy()[real],
                                  lay.nbh_idx[real])


def test_cell_gather_launch_arguments_are_the_stack_view(monkeypatch):
    """K16's ``SelectArgs``, made once per refs: the stack view's grid,
    rows P' = nz*C and slots Ktot' = nz*C*K, no bucket offsets or halo,
    and the cell index mode's nz, C and K; the column layout's carry
    nz = 0, which keeps K11 and K13 in their column modes."""
    from schnetpack_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "check", lambda *a, **k: None)
    refs = cg.CellRefs(torch.tensor(cell_case(seed=5, dims=(2, 2, 1))["qidx"]))
    addr = cg._select_args(refs)
    assert cg._select_args(refs) == addr
    a = sel.SelectArgs.from_address(addr)
    nx, ny, nz, C, K = refs.dims
    assert (a.nx, a.ny, a.P, a.Ktot, a.hx, a.hy, a.nz, a.C, a.K) == (
        nx, ny, nz * C, nz * C * K, 0, 0, nz, C, K)
    assert list(a.koffs) == [0] * 10
    col = ColRefs.from_layout(message_case(seed=2)["lay"])
    c = sel.SelectArgs.from_address(sel._check_refs(col)[-1])
    assert (c.nz, c.C, c.K) == (0, 0, 0) and c.P == col.P
