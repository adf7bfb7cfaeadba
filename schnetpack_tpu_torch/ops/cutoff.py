"""Smooth cutoff envelopes (parity: ``schnetpack_tpu/ops/cutoff.py``).

All are mask-safe: distances beyond the cutoff give exactly 0 with finite
gradients.
"""
from __future__ import annotations

import math

import torch


def cosine_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Behler-style cosine cutoff: 0.5*(cos(pi d/rc)+1) for d<rc else 0."""
    f = 0.5 * (torch.cos(d * (math.pi / cutoff)) + 1.0)
    return torch.where(d < cutoff, f, torch.zeros_like(f))


def mollifier_cutoff(d: torch.Tensor, cutoff: float,
                     eps: float = 1e-7) -> torch.Tensor:
    """exp(1 - 1/(1-(d/rc)^2)) inside the cutoff, 0 outside."""
    mask = (d + eps) < cutoff
    ratio = torch.where(mask, d / cutoff, torch.zeros_like(d))
    exponent = 1.0 - 1.0 / torch.clamp(1.0 - ratio ** 2, min=eps)
    return torch.where(mask, torch.exp(exponent), torch.zeros_like(d))


def _switch_component(x: torch.Tensor) -> torch.Tensor:
    """exp(-1/x) for x > 0, else 0 -- building block of the smooth switch."""
    x_safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, torch.exp(-1.0 / x_safe), torch.zeros_like(x))


def switch_function(d: torch.Tensor, switch_on: float,
                    switch_off: float) -> torch.Tensor:
    """Smooth 1 -> 0 transition between ``switch_on`` and ``switch_off``
    (1 for d <= switch_on, 0 for d >= switch_off, all derivatives
    continuous)."""
    x = (d - switch_on) / (switch_off - switch_on)
    fp = _switch_component(x)
    fm = _switch_component(1.0 - x)
    return torch.where(x <= 0, torch.ones_like(x),
                       torch.where(x >= 1, torch.zeros_like(x),
                                   fm / (fp + fm + 1e-30)))
