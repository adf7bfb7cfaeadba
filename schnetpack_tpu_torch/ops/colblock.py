"""Column-bucketed neighbor ops: index decode and plain PyTorch twins.

Port of ``schnetpack_tpu/ops/colblock.py``.  Edge slot ``k`` of column
(x, y) lies in bucket c9 (ragged, see ``ColRefs.koffs``); its source is
row ``qcol`` of column ((x+dx) mod nx, (y+dy) mod ny) with
c9 = (dx+1)*3 + (dy+1), its destination row ``dcol`` of column (x, y).
The functions here are the straightforward gather / per-edge math / fold
formulation that the CUDA message kernels (``colblock_message.py``) are
held against; they run everything as ordinary autograd-able tensor ops.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from .cutoff import cosine_cutoff

@dataclass(frozen=True)
class ColRefs:
    """Per-rebuild column-layout index tensors."""

    qcol: torch.Tensor   # [nx, ny, Ktot] int32 in-column source row (-1 pad)
    dcol: torch.Tensor   # [nx, ny, Ktot] int32 in-column destination row
    P: int               # per-column atom capacity
    ksizes: Tuple[int, ...]  # 9 bucket capacities
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
        return tuple(int(v) for v in np.concatenate([[0],
                                                     np.cumsum(self.ksizes)]))


def _c9_of_slot(ksizes) -> np.ndarray:
    return np.repeat(np.arange(9), np.asarray(ksizes))


def decode_j(refs: ColRefs):
    """Global sorted index of each edge's source atom, and the edge mask."""
    qcol = refs.qcol.long()
    nx, ny, _ = qcol.shape
    dev = qcol.device
    valid = qcol >= 0
    c9 = torch.as_tensor(_c9_of_slot(refs.ksizes), device=dev)
    x = torch.arange(nx, device=dev)[:, None, None]
    y = torch.arange(ny, device=dev)[None, :, None]
    xs = torch.remainder(x + c9 // 3 - 1, nx)
    ys = torch.remainder(y + c9 % 3 - 1, ny)
    j = (xs * ny + ys) * refs.P + qcol.clamp(min=0)
    return j, valid


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
    """Per-edge source rows [nx, ny, Ktot, D] (zeros at padded slots)."""
    j, valid = decode_j(refs)
    return table[j] * valid[..., None].to(table.dtype)


def column_fold(edge_vals: torch.Tensor, refs: ColRefs) -> torch.Tensor:
    """Sum per destination atom: [nx, ny, Ktot, D] -> [A', D]."""
    i, valid = decode_i(refs)
    nx, ny, _ = i.shape
    D = edge_vals.shape[-1]
    v = (edge_vals * valid[..., None].to(edge_vals.dtype)).reshape(-1, D)
    out = edge_vals.new_zeros((nx * ny * refs.P, D))
    return out.index_add(0, i.reshape(-1), v)


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

    x [A', 3F] context, mu [A', 3F] flat vector features, FW_aug [B+1, 3F]
    filter weights with the bias as last row.  Returns the per-atom sums
    dq [A', F] and dmu [A', 3F]."""
    F = x.shape[1] // 3
    xj = column_gather(x, refs)
    muj = column_gather(mu, refs)
    xjW = xj * (rbf_aug @ FW_aug)
    dq, dmuR, dmumu = xjW.split(F, dim=-1)
    msg = [dq] + [dmuR * dirs[..., c:c + 1] + dmumu * muj[..., c * F:(c + 1) * F]
                  for c in range(3)]
    folded = column_fold(torch.cat(msg, dim=-1), refs)
    return folded[:, :F], folded[:, F:]
