"""On-device rebuild of the column-bucketed neighbor state (plain torch).

Port of ``schnetpack_tpu/ops/colblock_rebuild.py``, which has no Pallas
kernel: the JAX package leaves it to XLA, and the port to PyTorch's own
device ops.  With the grid (nx, ny), the column capacity P and the nine
bucket capacities fixed, the per-edge state (qcol/dcol/offsets/emask) is
recomputed from the positions without leaving the device:

* candidate edges are the 9 neighbor columns' P x P pairs; the periodic
  image is chosen by minimum image on the bead centroid, the shift
  clipped to +-1 (valid while every box height exceeds twice the build
  cutoff, which the caller checks);
* in bucket 4 (the own column) self pairs are dropped unless they are a
  genuine periodic image;
* per (column, bucket) the pairs are compacted in (destination row,
  source row) order by sorting the unique keys ``iota`` (within cutoff) /
  ``P*P + iota`` (not) and gathering the packed payload, which gives the
  order of the JAX package's ``sort_key_val``; the result is sliced to the
  bucket capacity, and an overflow is reported as a device scalar.

``rebin_and_rebuild`` first re-bins the atoms into their current columns
(a stable argsort of column + z) and re-permutes the sorted-space tables.
Nothing crosses to the host: the caller reads the overflow flag once and
falls back to the host builder when it is set.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

COL_OFFSETS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


def _inv(cell: torch.Tensor) -> torch.Tensor:
    # inv_ex: no error check, so no host synchronisation on CUDA
    return torch.linalg.inv_ex(cell).inverse


def rebuild_column_state(
    R_beads: torch.Tensor,    # [S, A', 3] sorted-table positions (>=1 bead)
    slot_mask: torch.Tensor,  # [A'] 1.0 for real atoms
    cell: torch.Tensor,       # [3, 3]
    nx: int, ny: int, P: int, ksizes: Tuple[int, ...], rc: float,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Recompute qcol/dcol/coff/coff_fm/emask; returns (state, overflow).

    The edge set is the union over beads (axis 0 of ``R_beads``); images
    are chosen by minimum image on the bead centroid."""
    S = R_beads.shape[0]
    dt, dev = R_beads.dtype, R_beads.device
    R4 = R_beads.reshape(S, nx, ny, P, 3)
    cen4 = R4.mean(0)                                   # [nx, ny, P, 3]
    valid = (slot_mask > 0).reshape(nx, ny, P)
    inv_cell = _inv(cell)
    rc2 = rc * rc
    p_ids = torch.arange(P, device=dev)
    iota = torch.arange(P * P, dtype=torch.int32, device=dev)[None, :]
    qcols, dcols, offs, emasks = [], [], [], []
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for c9, (dx, dy) in enumerate(COL_OFFSETS):
        kc = ksizes[c9]

        def roll(a):
            return torch.roll(a, (-dx, -dy), dims=(0, 1))

        # centroid image choice for this bucket's source columns
        diff_c = roll(cen4)[:, :, None] - cen4[:, :, :, None]
        shift = torch.clamp(-torch.round(diff_c @ inv_cell), -1.0, 1.0)
        off_c = shift @ cell                            # [nx, ny, P, P, 3]
        within = torch.zeros((nx, ny, P, P), dtype=torch.bool, device=dev)
        for s in range(S):
            d = roll(R4[s])[:, :, None] - R4[s][:, :, :, None] + off_c
            within |= (d * d).sum(-1) < rc2
        mask = within & valid[:, :, :, None] & roll(valid)[:, :, None, :]
        if dx == 0 and dy == 0:
            # exclude self pairs unless they are genuine periodic images
            self_pair = p_ids[:, None] == p_ids[None, :]
            real_image = (shift.abs() > 0.5).any(-1)
            mask = mask & (~self_pair | real_image)

        # compact (dest p, src q) pairs bucket-first: sort the unique keys
        m2 = mask.reshape(nx * ny, P * P)
        key = torch.where(m2, iota, P * P + iota)
        sh = (shift + 1).to(torch.int32).reshape(nx * ny, P * P, 3)
        payload = ((iota << 6) | (sh[..., 0] << 4) | (sh[..., 1] << 2)
                   | sh[..., 2])
        idx = torch.sort(key, dim=-1).indices[:, :kc]
        packed = payload.gather(1, idx)
        if packed.shape[1] < kc:           # a bucket wider than P*P
            packed = torch.nn.functional.pad(packed, (0, kc - P * P))
        count = m2.sum(-1)                                # [ncol]
        ovf = ovf | (count > kc).any()
        live = torch.arange(kc, device=dev)[None, :] < count[:, None]

        pq = packed >> 6
        sh_e = torch.stack([((packed >> 4) & 3) - 1, ((packed >> 2) & 3) - 1,
                            (packed & 3) - 1], dim=-1).to(dt)
        qcols.append(torch.where(live, pq % P, -1).to(torch.int32))
        dcols.append(torch.where(live, pq // P, -1).to(torch.int32))
        offs.append((sh_e @ cell) * live[..., None])
        emasks.append(live.to(dt))

    coff = torch.cat(offs, dim=1).reshape(nx, ny, -1, 3)
    state = {
        "qcol": torch.cat(qcols, dim=1).reshape(nx, ny, -1),
        "dcol": torch.cat(dcols, dim=1).reshape(nx, ny, -1),
        "coff": coff,
        "coff_fm": coff.movedim(3, 2).contiguous(),
        "emask": torch.cat(emasks, dim=1).reshape(nx, ny, -1),
    }
    return state, ovf


def rebin_and_rebuild(
    positions: torch.Tensor,  # [S, A, 3] canonical-order positions
    order: torch.Tensor,      # [A'] old slot -> canonical atom (0 at pads)
    slot_mask: torch.Tensor,  # [A'] 1.0 for real atoms (old binning)
    Z_s: torch.Tensor,        # [A'] sorted-space atomic numbers
    idx_m_s: torch.Tensor,    # [A'] sorted-space molecule ids
    cell: torch.Tensor,
    nx: int, ny: int, P: int, ksizes: Tuple[int, ...], rc: float,
):
    """Re-bin the atoms into their current xy columns (bead-centroid
    fractional coordinates, z-ordered within a column, one stable device
    sort), re-permute the sorted-space tables and rebuild the edge state.

    Returns (state with the edge tensors and the new order/rank/Z/idx_m/
    atom_mask, overflow flag).  Overflow (a column above P or a bucket
    above its capacity) means the caller must fall back to the host
    builder."""
    Acan = positions.shape[1]
    Ap = order.shape[0]
    n_cols = nx * ny
    dt, dev = positions.dtype, positions.device
    cen = positions[:, order].mean(0)
    frac = cen @ _inv(cell)
    frac = frac - torch.floor(frac)
    colx = torch.clamp((frac[:, 0] * nx).to(torch.int32), 0, nx - 1)
    coly = torch.clamp((frac[:, 1] * ny).to(torch.int32), 0, ny - 1)
    col = torch.where(slot_mask > 0, colx * ny + coly, n_cols)
    key = col.to(torch.float32) + frac[:, 2].to(torch.float32) * 0.999
    perm = torch.argsort(key, stable=True)              # sorted -> old slot
    s = col[perm].contiguous()
    first = torch.searchsorted(s, s)
    within = torch.arange(Ap, device=dev) - first
    real = s < n_cols
    ovf = (real & (within >= P)).any()
    tgt = torch.where(real & (within < P), s * P + within, Ap)

    inv_map = torch.full((Ap + 1,), -1, dtype=perm.dtype, device=dev)
    inv_map = inv_map.index_put((tgt,), perm)[:Ap]
    new_mask = inv_map >= 0
    safe = inv_map.clamp(min=0)
    order_new = order[safe] * new_mask
    slots = torch.arange(Ap, dtype=order.dtype, device=dev)
    rank_new = torch.zeros(Acan + 1, dtype=order.dtype, device=dev)
    rank_new = rank_new.index_put(
        (torch.where(new_mask, order_new, Acan),), slots)[:Acan]

    mask_f = new_mask.to(dt)
    R_new = positions[:, order_new] * mask_f[None, :, None]
    state, ovf_b = rebuild_column_state(R_new, mask_f, cell, nx, ny, P,
                                        ksizes, rc)
    state.update({
        "order": order_new,
        "rank": rank_new,
        "Z": Z_s[safe] * new_mask,
        "idx_m": idx_m_s[safe] * new_mask,
        "atom_mask": mask_f,
    })
    return state, ovf | ovf_b
