"""Mask-aware metrics over padded batches (port of
``schnetpack_tpu/train/metrics.py``).

Each metric returns ``(error_sum, count)`` so that the epoch's aggregate
over batches is exact.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _broadcast_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))


def masked_counts(pred: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Number of real scalar elements covered by the mask."""
    extra = 1.0
    for d in pred.shape[mask.ndim:]:
        extra *= d
    return mask.sum() * extra


def mae_sum(pred, target, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    m = _broadcast_mask(mask, pred)
    return ((pred - target).abs() * m).sum(), masked_counts(pred, mask)


def mse_sum(pred, target, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    m = _broadcast_mask(mask, pred)
    return ((pred - target).square() * m).sum(), masked_counts(pred, mask)


def tensor_diagonal_mae_sum(pred, target, mask, diagonal: bool = True):
    """MAE over the diagonal (or off-diagonal) elements of [..., 3, 3]
    tensors."""
    eye = torch.eye(pred.shape[-1], dtype=pred.dtype, device=pred.device)
    sel = eye if diagonal else 1.0 - eye
    m = _broadcast_mask(mask, pred) * sel
    return ((pred - target).abs() * m).sum(), mask.sum() * sel.sum()


METRICS = {
    "mae": mae_sum,
    "mse": mse_sum,
    "rmse": mse_sum,  # sqrt applied at aggregation time
    "tensor_diag_mae": lambda p, t, m: tensor_diagonal_mae_sum(p, t, m, True),
    "tensor_offdiag_mae": lambda p, t, m: tensor_diagonal_mae_sum(p, t, m,
                                                                  False),
}


def finalize_metric(name: str, total: float, count: float) -> float:
    v = total / max(count, 1.0)
    if name == "rmse":
        v = v ** 0.5
    return v
