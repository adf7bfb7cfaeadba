"""Numerically safe helpers (parity: ``schnetpack_tpu/ops/math.py``)."""
from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """L2 norm over the last axis with a zero gradient at 0
    (``schnetpack_tpu/ops/math.py:8-11``)."""
    return torch.sqrt(torch.clamp((x * x).sum(-1), min=eps))
