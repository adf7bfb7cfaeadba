"""Dense layer and MLP (parity: ``schnetpack_tpu/nn/base.py:15-80``)."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..ops.activations import shifted_softplus


class Dense(nn.Linear):
    """``nn.Linear`` with an optional activation and Xavier-uniform init.

    The weight is ``[out, in]`` (flax's Dense kernel is ``[in, out]``;
    ``convert.params_from_jax`` transposes)."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True,
                 activation: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_in, n_out, bias=bias)
        self.activation = activation
        with torch.no_grad():
            a = (6.0 / (n_in + n_out)) ** 0.5
            self.weight.uniform_(-a, a, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return y if self.activation is None else self.activation(y)


class MLP(nn.Module):
    """Pyramidal MLP: widths halve from ``n_in`` over ``n_layers``
    (parity: ``build_mlp``)."""

    def __init__(self, n_in: int, n_out: int,
                 hidden: Optional[Sequence[int]] = None, n_layers: int = 2,
                 activation: Callable = shifted_softplus,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden is None:
            hidden, w = [], n_in
            for _ in range(n_layers - 1):
                w = max(n_out, w // 2)
                hidden.append(w)
        widths = [n_in] + list(hidden)
        for i in range(len(hidden)):
            self.add_module(f"dense_{i}", Dense(
                widths[i], widths[i + 1], activation=activation,
                generator=generator))
        self.add_module(f"dense_{len(hidden)}",
                        Dense(widths[-1], n_out, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x
