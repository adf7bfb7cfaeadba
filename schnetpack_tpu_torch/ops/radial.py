"""Radial basis expansions and their parameters (parity:
``schnetpack_tpu/ops/radial.py:16-55``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def gaussian_rbf(d: torch.Tensor, centers: torch.Tensor,
                 widths: torch.Tensor) -> torch.Tensor:
    """exp(-0.5 * ((d - mu)/sigma)^2) -- d: [...], out: [..., n_rbf]."""
    coeff = -0.5 / widths ** 2
    diff = d[..., None] - centers
    return torch.exp(coeff * diff ** 2)


def gaussian_rbf_params(
    n_rbf: int, cutoff: float, start: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Evenly spaced centers on [start, cutoff]; width = center spacing."""
    centers = np.linspace(start, cutoff, n_rbf, dtype=np.float32)
    widths = np.full(
        n_rbf, np.abs(cutoff - start) / max(n_rbf - 1, 1), dtype=np.float32
    )
    return centers, widths


def gaussian_rbf_centered_params(
    n_rbf: int, cutoff: float, start: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """All gaussians centered at zero with widths spanning [start, cutoff]."""
    widths = np.linspace(start, cutoff, n_rbf, dtype=np.float32)
    centers = np.zeros(n_rbf, dtype=np.float32)
    return centers, widths


def bessel_rbf(d: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """DimeNet-style 0th-order spherical Bessel basis sin(n pi d/rc)/d.

    ``freqs`` = n*pi/rc for n = 1..n_rbf.  Safe at d == 0.
    """
    sinax = torch.sin(d[..., None] * freqs)
    norm = torch.where(d == 0.0, torch.ones_like(d), d)
    return sinax / norm[..., None]


def bessel_rbf_params(n_rbf: int, cutoff: float) -> np.ndarray:
    return np.arange(1, n_rbf + 1, dtype=np.float32) * np.pi / cutoff


def gaussian_rbf_table(n_rbf: int, cutoff: float, start: float = 0.0,
                       device=None) -> torch.Tensor:
    """``cw [B, 2]``: centers and ``-0.5/width**2``, the table the message
    kernels read (``schnetpack_tpu/representation/painn.py:328-335``)."""
    centers, widths = gaussian_rbf_params(n_rbf, cutoff, start)
    c = torch.as_tensor(centers, dtype=torch.float32)
    w = torch.as_tensor(widths, dtype=torch.float32)
    return torch.stack([c, -0.5 / w ** 2], dim=1).to(device)
