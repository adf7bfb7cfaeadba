"""Numerically safe helpers (parity: ``schnetpack_tpu/ops/math.py``)."""
from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """L2 norm over the last axis with a zero gradient at 0
    (``schnetpack_tpu/ops/math.py:8-11``)."""
    return torch.sqrt(torch.clamp((x * x).sum(-1), min=eps))


def stable_sinh_div(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """sinh(x) / x with the series 1 + x^2 / 6 below ``eps``
    (``schnetpack_tpu/ops/math.py:25``)."""
    small = x.abs() < eps
    x_safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 + x * x / 6.0, torch.sinh(x_safe) / x_safe)
