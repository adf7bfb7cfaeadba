"""Gaussian radial basis parameters (parity:
``schnetpack_tpu/ops/radial.py:23-31``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def gaussian_rbf_params(
    n_rbf: int, cutoff: float, start: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Evenly spaced centers on [start, cutoff]; width = center spacing."""
    centers = np.linspace(start, cutoff, n_rbf, dtype=np.float32)
    widths = np.full(
        n_rbf, np.abs(cutoff - start) / max(n_rbf - 1, 1), dtype=np.float32
    )
    return centers, widths


def gaussian_rbf_table(n_rbf: int, cutoff: float, start: float = 0.0,
                       device=None) -> torch.Tensor:
    """``cw [B, 2]``: centers and ``-0.5/width**2``, the table the message
    kernels read (``schnetpack_tpu/representation/painn.py:328-335``)."""
    centers, widths = gaussian_rbf_params(n_rbf, cutoff, start)
    c = torch.as_tensor(centers, dtype=torch.float32)
    w = torch.as_tensor(widths, dtype=torch.float32)
    return torch.stack([c, -0.5 / w ** 2], dim=1).to(device)
