"""Cosine cutoff (parity: ``schnetpack_tpu/ops/cutoff.py``)."""
from __future__ import annotations

import math

import torch


def cosine_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Behler-style cosine cutoff: 0.5*(cos(pi d/rc)+1) for d<rc else 0."""
    f = 0.5 * (torch.cos(d * (math.pi / cutoff)) + 1.0)
    return torch.where(d < cutoff, f, torch.zeros_like(f))
