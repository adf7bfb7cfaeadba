"""Cutoff modules (parity: ``schnetpack_tpu/nn/cutoff.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ..ops import cutoff as cutoff_ops


class CosineCutoff(nn.Module):
    def __init__(self, cutoff: float):
        super().__init__()
        self.cutoff = float(cutoff)

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        return cutoff_ops.cosine_cutoff(d, self.cutoff)


class MollifierCutoff(nn.Module):
    def __init__(self, cutoff: float, eps: float = 1e-7):
        super().__init__()
        self.cutoff = float(cutoff)
        self.eps = float(eps)

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        return cutoff_ops.mollifier_cutoff(d, self.cutoff, self.eps)


class SwitchFunction(nn.Module):
    def __init__(self, switch_on: float, switch_off: float):
        super().__init__()
        self.switch_on = float(switch_on)
        self.switch_off = float(switch_off)

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        return cutoff_ops.switch_function(d, self.switch_on, self.switch_off)
