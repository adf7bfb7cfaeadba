"""Column-bucketed neighbor ops: index decode and plain PyTorch twins.

Port of ``schnetpack_tpu/ops/colblock.py``.  Edge slot ``k`` of column
(x, y) lies in bucket c9 (ragged, see ``ColRefs.koffs``); its source is
row ``qcol`` of column ((x+dx) mod nx, (y+dy) mod ny) with
c9 = (dx+1)*3 + (dy+1), its destination row ``dcol`` of column (x, y).
The functions here are the straightforward gather / per-edge math / fold
formulation that the CUDA message kernels (``colblock_message.py``) are
held against; they run everything as ordinary autograd-able tensor ops.

Refs with a ``shard_axis`` (the slab path of ``parallel/columns.py``)
index their sources in the halo'd slab table of ``colblock_shard.py``
instead: column (x+dx+1, (y+dy) mod ny) of [nx+2, ny] columns for x
slabs, (x+dx+1, y+dy+1) of [nx+2, ny+2] for (x, y) blocks
(``decode_src``); gathers and source sorts follow it, destinations stay
local.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from dataclasses import dataclass, field
from typing import Tuple

import torch

from .cutoff import cosine_cutoff


@functools.lru_cache(maxsize=256)
def _bucket_offsets(ksizes: Tuple[int, ...]):
    """The bucket offsets of ``ksizes`` and their ``int[10]``, made once per
    bucket sizes: keyed by the sizes, so refs made by
    ``dataclasses.replace`` with other sizes get their own.  The kernels
    only read the array."""
    offs = tuple(itertools.accumulate((int(k) for k in ksizes), initial=0))
    return offs, (ctypes.c_int * len(offs))(*offs)


@dataclass(frozen=True)
class ColRefs:
    """Per-rebuild column-layout index tensors."""

    qcol: torch.Tensor   # [nx, ny, Ktot] int32 in-column source row (-1 pad)
    dcol: torch.Tensor   # [nx, ny, Ktot] int32 in-column destination row
    P: int               # per-column atom capacity
    ksizes: Tuple[int, ...]  # 9 bucket capacities
    #: the slab path's mesh axis ("cols") or axes ("cols", "cols_y"): the
    #: sources are rows of the x- or xy-halo'd table; None: wrapped
    shard_axis: object = None
    #: index tensors derived from these (e.g. the message backward's
    #: schedule), computed once per refs
    cache: dict = field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def from_layout(cls, lay, device=None) -> "ColRefs":
        nx, ny, P, ksizes = lay.dims
        return cls(torch.as_tensor(lay.qcol, device=device),
                   torch.as_tensor(lay.dcol, device=device), int(P),
                   tuple(int(k) for k in ksizes))

    @property
    def koffs(self) -> Tuple[int, ...]:
        """The 10 bucket offsets (0 and the cumulative bucket sizes)."""
        return _bucket_offsets(self.ksizes)[0]

    @property
    def koffs_arg(self) -> ctypes.Array:
        """``koffs`` as the kernels' ``int[10]`` argument."""
        return _bucket_offsets(self.ksizes)[1]

    @property
    def halo(self) -> Tuple[int, int]:
        """The source-index mode (hx, hy): (0, 0) wrap, (1, 0) x-halo'd
        slab, (1, 1) xy-halo'd block."""
        if self.shard_axis is None:
            return 0, 0
        two_d = (isinstance(self.shard_axis, (tuple, list))
                 and len(self.shard_axis) == 2)
        return 1, int(two_d)

    @property
    def src_cols(self) -> Tuple[int, int]:
        """The source table's column grid (nx [+2], ny [+2])."""
        nx, ny, _ = self.qcol.shape
        hx, hy = self.halo
        return nx + 2 * hx, ny + 2 * hy

    @property
    def src_rows(self) -> int:
        """The source table's rows."""
        sx, sy = self.src_cols
        return sx * sy * self.P


def decode_j(refs: ColRefs):
    """Global sorted index of each edge's source atom, and the edge mask.
    The bucket of each slot is counted on the device from the bucket
    offsets (a host-to-device copy here would synchronise the host with
    the card on every step)."""
    qcol = refs.qcol.long()
    nx, ny, Ktot = qcol.shape
    dev = qcol.device
    valid = qcol >= 0
    slot = torch.arange(Ktot, device=dev)
    c9 = sum((slot >= o).long() for o in refs.koffs[1:9])
    x = torch.arange(nx, device=dev)[:, None, None]
    y = torch.arange(ny, device=dev)[None, :, None]
    xs = torch.remainder(x + c9 // 3 - 1, nx)
    ys = torch.remainder(y + c9 % 3 - 1, ny)
    j = (xs * ny + ys) * refs.P + qcol.clamp(min=0)
    return j, valid


def decode_src(refs: ColRefs):
    """Row of each edge's source atom in the source table (the wrapped
    [nx, ny] table, or the halo'd slab of a sharded ``refs``), and the
    edge mask."""
    hx, hy = refs.halo
    if not hx:
        return decode_j(refs)
    from .colblock_shard import _decode_hx

    return _decode_hx(refs.qcol, refs.koffs, refs.qcol.shape[1], refs.P,
                      bool(hy))


def decode_i(refs: ColRefs):
    """Global sorted index of each edge's destination atom, and the mask."""
    dcol = refs.dcol.long()
    nx, ny, _ = dcol.shape
    dev = dcol.device
    x = torch.arange(nx, device=dev)[:, None, None]
    y = torch.arange(ny, device=dev)[None, :, None]
    i = (x * ny + y) * refs.P + dcol.clamp(min=0)
    return i, dcol >= 0


def column_gather(table: torch.Tensor, refs: ColRefs) -> torch.Tensor:
    """Per-edge source rows [nx, ny, Ktot, D] of the source table (zeros at
    padded slots)."""
    j, valid = decode_src(refs)
    return table[j] * valid[..., None].to(table.dtype)


def column_expand(table: torch.Tensor, refs: ColRefs) -> torch.Tensor:
    """Per-edge destination rows [nx, ny, Ktot, D] (zeros at padded
    slots)."""
    i, valid = decode_i(refs)
    return table[i] * valid[..., None].to(table.dtype)


def column_fold(edge_vals: torch.Tensor, refs: ColRefs) -> torch.Tensor:
    """Sum per destination atom: [nx, ny, Ktot, D] -> [A', D]."""
    i, valid = decode_i(refs)
    nx, ny, _ = i.shape
    D = edge_vals.shape[-1]
    v = (edge_vals * valid[..., None].to(edge_vals.dtype)).reshape(-1, D)
    out = edge_vals.new_zeros((nx * ny * refs.P, D))
    return out.index_add(0, i.reshape(-1), v)


def source_order(refs: ColRefs):
    """Every edge slot (destination column * Ktot + slot) sorted by its row
    in the source table, padded slots last (``esorted`` int32), the slots
    per source row (``cnt`` int64) and the start of each row's run
    (``rowptr`` int32).  Computed once per ``refs`` (cached on it) on the
    device, without a host synchronisation."""
    if "src" in refs.cache:
        return refs.cache["src"]
    n = refs.src_rows
    j, valid = decode_src(refs)
    key = torch.where(valid, j, n).reshape(-1)
    esorted = torch.argsort(key, stable=True).to(torch.int32)
    cnt = torch.zeros(n + 1, dtype=torch.int64, device=key.device)
    cnt = cnt.index_add_(0, key, torch.ones_like(key))[:-1]
    rowptr = torch.cat([cnt.new_zeros(1), cnt.cumsum(0)]).to(torch.int32)
    refs.cache["src"] = (esorted, cnt, rowptr)
    return refs.cache["src"]


def row_groups(cnt: torch.Tensor, G: int) -> torch.Tensor:
    """Cut the rows of each column into G ranges of about equal edge count:
    ``cnt`` [n_cols, P] holds the slots of each row, in the order that a
    sort by (column, row) lists them.  Returns [n_cols, G+1, 2] int32
    bounds (row, index of the range's first slot in that sorted order);
    range g of column c is rows [b[c, g, 0], b[c, g+1, 0]) and slots
    [b[c, g, 1], b[c, g+1, 1]).  Each bound follows the row at which the
    column's running count first reaches its share, so a range's count is
    within one row's degree of the equal share.  Fixed shapes, no host
    synchronisation."""
    P = cnt.shape[1]
    cum = cnt.cumsum(1)
    steps = torch.arange(1, G, device=cnt.device)
    inner = torch.searchsorted(cum, (cum[:, -1:] * steps) // G) + 1
    rows = torch.cat([torch.zeros_like(cum[:, :1]), inner.clamp(max=P),
                      torch.full_like(cum[:, :1], P)], dim=1)
    cumx = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
    col_start = (cum[:, -1].cumsum(0) - cum[:, -1])[:, None]
    edges = col_start + cumx.gather(1, rows)
    return torch.stack([rows, edges], dim=-1).to(torch.int32).contiguous()


def destination_order(refs: ColRefs):
    """Every real edge slot (column * Ktot + slot) sorted by (destination
    column, destination row), slot order within a row, padded slots last
    (``dsorted`` int32), and the slots per destination row (``cnt`` int64
    [nx*ny*P]).  Computed once per ``refs`` (cached on it) on the device,
    without a host synchronisation."""
    if "dst" in refs.cache:
        return refs.cache["dst"]
    nx, ny, _ = refs.qcol.shape
    n = nx * ny * refs.P
    col = torch.arange(nx * ny, device=refs.qcol.device).view(nx, ny, 1)
    key = torch.where(refs.qcol >= 0, col * refs.P + refs.dcol.long(),
                      n).reshape(-1)
    dsorted = torch.argsort(key, stable=True).to(torch.int32)
    cnt = torch.zeros(n + 1, dtype=torch.int64, device=key.device)
    cnt = cnt.index_add_(0, key, torch.ones_like(key))[:-1]
    refs.cache["dst"] = (dsorted, cnt)
    return refs.cache["dst"]


def destination_schedule(refs: ColRefs, G: int):
    """The message forward's schedule (``csrc/colblock_message.cu``): the
    destination-sorted slots of ``destination_order`` and each column's
    rows cut into G ranges of about equal edge count (``row_groups``), one
    block each.  Made once per (``refs``, G) and cached on the refs."""
    key = ("dst", G)
    if key not in refs.cache:
        dsorted, cnt = destination_order(refs)
        nx, ny, _ = refs.qcol.shape
        refs.cache[key] = (dsorted, row_groups(cnt.view(nx * ny, refs.P), G))
    return refs.cache[key]


def column_geometry(R: torch.Tensor, coff_fm: torch.Tensor, refs: ColRefs,
                    cw: torch.Tensor, rc: float, with_d: bool = False,
                    raw_phi: bool = False):
    """Per-edge geometry from sorted positions R [A', 3].

    Returns ``rbf_aug`` [nx, ny, Ktot, B+1] = [phi*fcut, fcut] (``raw_phi``:
    [phi*mask, fcut], SchNet's form) and the unit directions ``dirs``
    [nx, ny, Ktot, 3], with padded slots exactly zero: d = sqrt(|rij|^2 +
    1 - mask) keeps them finite.  ``with_d`` also returns the distances d
    [nx, ny, Ktot, 1] (1 at padded slots).
    """
    j, valid = decode_j(refs)
    i, _ = decode_i(refs)
    m = valid.to(R.dtype)[..., None]
    rij = (R[j] + coff_fm.movedim(2, 3) - R[i]) * m
    d = torch.sqrt((rij * rij).sum(-1, keepdim=True) + 1.0 - m)
    dirs = rij / d
    fcut = cosine_cutoff(d, rc) * m
    phi = torch.exp(cw[:, 1] * (d - cw[:, 0]) ** 2)
    rbf_aug = torch.cat([phi * (m if raw_phi else fcut), fcut], dim=-1)
    return (rbf_aug, dirs, d) if with_d else (rbf_aug, dirs)


def painn_message(x: torch.Tensor, mu: torch.Tensor, rbf_aug: torch.Tensor,
                  dirs: torch.Tensor, FW_aug: torch.Tensor, refs: ColRefs):
    """PaiNN inter-atomic message (``_painn_message_xla``).

    x [A', 3F] context, mu [A', 3F] flat vector features (rows of the
    source table: halo'd for sharded ``refs``, ``_msg_hx_xla``), FW_aug
    [B+1, 3F] filter weights with the bias as last row.  Returns the
    per-atom sums dq [A', F] and dmu [A', 3F]."""
    F = x.shape[1] // 3
    xj = column_gather(x, refs)
    muj = column_gather(mu, refs)
    xjW = xj * (rbf_aug @ FW_aug)
    dq, dmuR, dmumu = xjW.split(F, dim=-1)
    msg = [dq] + [dmuR * dirs[..., c:c + 1] + dmumu * muj[..., c * F:(c + 1) * F]
                  for c in range(3)]
    folded = column_fold(torch.cat(msg, dim=-1), refs)
    return folded[:, :F], folded[:, F:]
