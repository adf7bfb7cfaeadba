"""Radial basis modules (parity: ``schnetpack_tpu/nn/radial.py:11-62``).

A trainable basis holds ``centers`` and ``widths`` as parameters (the
flax params ``radial_basis/{centers,widths}``); a fixed one keeps them as
buffers that are not saved, as the JAX modules keep them as constants.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import radial as radial_ops


class _Gaussian(nn.Module):
    def __init__(self, n_rbf: int, cutoff: float, start: float,
                 trainable: bool, params):
        super().__init__()
        self.n_rbf = n_rbf
        self.cutoff = float(cutoff)
        self.start = float(start)
        self.trainable = trainable
        for name, value in zip(("centers", "widths"), params):
            value = torch.as_tensor(value)
            if trainable:
                setattr(self, name, nn.Parameter(value))
            else:
                self.register_buffer(name, value, persistent=False)

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        return radial_ops.gaussian_rbf(d, self.centers, self.widths)


class GaussianRBF(_Gaussian):
    """Gaussians with evenly spaced centers on [start, cutoff]."""

    def __init__(self, n_rbf: int, cutoff: float, start: float = 0.0,
                 trainable: bool = False):
        super().__init__(n_rbf, cutoff, start, trainable,
                         radial_ops.gaussian_rbf_params(n_rbf, cutoff, start))


class GaussianRBFCentered(_Gaussian):
    """Gaussians centered at zero with widths spanning [start, cutoff]."""

    def __init__(self, n_rbf: int, cutoff: float, start: float = 1.0,
                 trainable: bool = False):
        super().__init__(n_rbf, cutoff, start, trainable,
                         radial_ops.gaussian_rbf_centered_params(
                             n_rbf, cutoff, start))


class BesselRBF(nn.Module):
    """sin(n pi d/rc)/d for n = 1..n_rbf (no parameters)."""

    def __init__(self, n_rbf: int, cutoff: float):
        super().__init__()
        self.n_rbf = n_rbf
        self.cutoff = float(cutoff)
        self.register_buffer("freqs", torch.as_tensor(
            radial_ops.bessel_rbf_params(n_rbf, cutoff)), persistent=False)

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        return radial_ops.bessel_rbf(d, self.freqs)
