"""Row gather of the 27-cell atom layout: CUDA kernels K16/K17 and their
twins.

Port of ``schnetpack_tpu.ops.cellblock.cell_gather`` and its Pallas
kernels (``ops/cellblock_pallas.py:88`` forward, ``:143`` backward):
``cell_gather(table [A', D], qidx [nx, ny, nz, C, K]) -> [A', K, D]``
picks each edge slot's source row, zeros where ``qidx`` is -1; its VJP is
the per-source-row sum, the transpose (``cellblock.py:165-185``).  Both
run on the column select kernels (``csrc/colblock_select.cu``) over the
layout's stack view (``csrc/cellblock.cuh``: the nz cells of an (x, y) as
one column of nz*C rows): K16 is the gather in a cell index mode, which
decodes each slot's code in the kernel, and K17 the row sums that K12
and K14 run, on this layout's source order.  They take any width D; the
MD path gathers the positions (D = 3).

Slot (a, k) with code q = o*C + s names row s of the neighbor cell
(x+dx, y+dy, z+dz) (periodic) of the destination's cell (x, y, z), with
(dx, dy, dz) = ``OFFSETS[o]``.  ``CellRefs`` carries ``qidx`` and caches
what is derived from it once per neighbor state: the decoded source rows,
K16's launch arguments, the source-sorted slot order that K17 walks, and
the message kernels' schedules on the stack view, which K18 and K19
walk.  On CPU tensors the op runs the twins, on CUDA tensors the kernels,
and it raises for any other device.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from . import _build
from .colblock import row_groups, sorted_runs
from .colblock_select import SelectArgs

#: kernel launches since the last reset (painn_cell MD: K16 1, K17 1 per
#: step)
LAUNCHES = {"cell_gather_fwd": 0, "cell_gather_bwd": 0}


@dataclass(frozen=True)
class CellRefs:
    """Per-rebuild index tensor of the 27-cell layout."""

    qidx: torch.Tensor   # [nx, ny, nz, C, K] int32 o*C + s (-1 pad)
    #: index tensors derived from it, computed once per refs
    cache: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def dims(self):
        return tuple(int(v) for v in self.qidx.shape)

    @property
    def n_rows(self) -> int:
        nx, ny, nz, C, _ = self.dims
        return nx * ny * nz * C

    @property
    def stack(self):
        """The stack view (``csrc/cellblock.cuh``): nx*ny columns of
        P' = nz*C rows and Ktot' = nz*C*K slots each."""
        nx, ny, nz, C, K = self.dims
        return nx * ny, nz * C, nz * C * K


def as_refs(qidx) -> CellRefs:
    return qidx if isinstance(qidx, CellRefs) else CellRefs(qidx)


def decode_cell_j(refs: CellRefs):
    """Sorted-space source row j [A', K] (int64, 0 at padded slots) of
    every edge slot, and the slot mask [A', K]."""
    if "j" in refs.cache:
        return refs.cache["j"]
    q = refs.qidx.long()
    nx, ny, nz, C, K = q.shape
    dev = q.device
    valid = q >= 0
    qc = q.clamp(min=0)
    o, s = qc // C, qc % C
    ar = [torch.arange(n, device=dev) for n in (nx, ny, nz)]
    sx = torch.remainder(ar[0][:, None, None, None, None] + o // 9 - 1, nx)
    sy = torch.remainder(ar[1][None, :, None, None, None] + o // 3 % 3 - 1,
                         ny)
    sz = torch.remainder(ar[2][None, None, :, None, None] + o % 3 - 1, nz)
    j = ((sx * ny + sy) * nz + sz) * C + s
    refs.cache["j"] = (j.reshape(-1, K), valid.reshape(-1, K))
    return refs.cache["j"]


def source_order(refs: CellRefs):
    """Every edge slot a*K + k sorted by its source row, padded slots last
    (``esorted`` int32 [A'*K]), the slots per source row (``cnt`` int32
    [A']) and the start of each row's run (``rowptr`` int32 [A'+1]), as
    ``colblock.sorted_runs`` gives them: on the device, without a host
    synchronisation, once per ``refs``."""
    if "src" not in refs.cache:
        n = refs.n_rows
        j, valid = decode_cell_j(refs)
        refs.cache["src"] = sorted_runs(torch.where(valid, j, n).reshape(-1),
                                        n)
    return refs.cache["src"]


def stack_destination_schedule(refs: CellRefs, G: int):
    """K18's schedule (the column forward's, ``colblock.
    destination_schedule``, on the stack view): every real slot in slot
    order, which is destination order, padded slots last (``dsorted``
    int32 [A'*K]), and each stack's rows cut into G ranges of about equal
    slot count (``row_groups`` [nx*ny, G+1, 2]).  Made once per (refs, G)
    on the device, without a host synchronisation."""
    key = ("stack_dst", G)
    if key not in refs.cache:
        n_cols, P, _ = refs.stack
        pad = (refs.qidx < 0).reshape(-1).to(torch.int32)
        dsorted = torch.argsort(pad, stable=True).to(torch.int32)
        cnt = (refs.qidx >= 0).sum(-1).reshape(n_cols, P)
        refs.cache[key] = (dsorted, row_groups(cnt, G))
    return refs.cache[key]


def stack_source_schedule(refs: CellRefs, G: int):
    """K19's schedule (the column backward's, ``colblock.source_schedule``,
    on the stack view): ``source_order``'s slots, sorted by source row, and
    each stack's rows cut into G ranges of about equal slot count.  Made
    once per (refs, G) on the device."""
    key = ("stack_src", G)
    if key not in refs.cache:
        n_cols, P, _ = refs.stack
        esorted, cnt, _ = source_order(refs)
        refs.cache[key] = (esorted, row_groups(cnt.view(n_cols, P), G))
    return refs.cache[key]


def _check_refs(refs: CellRefs):
    _build.check(refs.qidx, "qidx", refs.dims, torch.int32)
    return refs.n_rows, refs.dims[4]


def _select_args(refs: CellRefs) -> int:
    """Address of K16's ``SelectArgs``, made once per refs: the stack
    view's column grid, rows and slots, and the cell index mode's nz, C
    and K."""
    if "select_args" not in refs.cache:
        nx, ny, nz, C, K = refs.dims
        _, P, Kt = refs.stack
        refs.cache["select_args"] = SelectArgs(nx=nx, ny=ny, P=P, Ktot=Kt,
                                               nz=nz, C=C, K=K)
    return ctypes.addressof(refs.cache["select_args"])


def cell_gather_fwd_kernel(table, qidx):
    """K16: out [A', K, D], out[a, k] = table[j(a, k)], 0 at padded slots."""
    refs = as_refs(qidx)
    Ap, K = _check_refs(refs)
    D = table.shape[-1]
    _build.check(table, "table", (Ap, D))
    out = table.new_empty((Ap, K, D))
    _build.launch("spk_cell_gather_fwd", table.data_ptr(),
                  refs.qidx.data_ptr(), out.data_ptr(), _select_args(refs),
                  D)
    LAUNCHES["cell_gather_fwd"] += 1
    return out


def cell_gather_bwd_kernel(g, qidx):
    """K17: the gather's VJP, dT [A', D] = per-source-row sums of g (K12's
    row sums on ``source_order``)."""
    refs = as_refs(qidx)
    Ap, K = _check_refs(refs)
    D = g.shape[-1]
    _build.check(g, "g", (Ap, K, D))
    esorted, _, rowptr = source_order(refs)
    dT = g.new_empty((Ap, D))
    p = _build.ptr
    _build.launch("spk_row_sums", p(g), p(esorted), p(rowptr), p(dT), Ap, D)
    LAUNCHES["cell_gather_bwd"] += 1
    return dT


def cell_gather_plain(table, qidx):
    """Plain twin of K16 (``_cell_gather_fwd_impl``), by decoded index."""
    j, valid = decode_cell_j(as_refs(qidx))
    return table[j] * valid[..., None].to(table.dtype)


def cell_gather_bwd_plain(g, qidx):
    """Plain twin of K17 (``_cell_gather_bwd``): the transpose."""
    refs = as_refs(qidx)
    j, valid = decode_cell_j(refs)
    D = g.shape[-1]
    v = (g * valid[..., None].to(g.dtype)).reshape(-1, D)
    return g.new_zeros((refs.n_rows, D)).index_add(0, j.reshape(-1), v)


def _on(t: torch.Tensor, kernel, plain, *args):
    """The kernel for a CUDA tensor, the twin for a CPU tensor."""
    if t.is_cuda:
        return kernel(*args)
    if t.device.type == "cpu":
        return plain(*args)
    raise ValueError(f"no cell-layout kernel for device {t.device}")


class CellGather(torch.autograd.Function):
    """Forward K16, backward K17 on CUDA; their twins on the CPU."""

    @staticmethod
    def forward(ctx, table, refs):
        ctx.refs = refs
        return _on(table, cell_gather_fwd_kernel, cell_gather_plain, table,
                   refs)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return _on(g, cell_gather_bwd_kernel, cell_gather_bwd_plain, g,
                   ctx.refs), None


def cell_gather(table, qidx):
    """Neighbor rows [A', K, D] of a cell-sorted table [A', D]
    (``schnetpack_tpu.ops.cellblock.cell_gather``); ``qidx`` is the
    [nx, ny, nz, C, K] code tensor or its ``CellRefs``."""
    return CellGather.apply(table.contiguous(), as_refs(qidx))
