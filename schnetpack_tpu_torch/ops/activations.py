"""Activation functions (parity: ``schnetpack_tpu/ops/activations.py``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LOG2 = math.log(2.0)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - ln(2); zero-centered at x=0 (SchNet's ssp)."""
    return F.softplus(x) - _LOG2


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


#: activation by name; the kernels take the same names ("ssp" | "silu")
ACTIVATIONS = {"ssp": shifted_softplus, "silu": silu}
