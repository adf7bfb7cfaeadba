"""Dense layer, MLP and residual blocks (parity:
``schnetpack_tpu/nn/base.py:15-112``)."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..ops.activations import shifted_softplus


class Dense(nn.Linear):
    """``nn.Linear`` with an optional activation and Xavier-uniform init.

    The weight is ``[out, in]`` (flax's Dense kernel is ``[in, out]``;
    ``convert.params_from_jax`` transposes); ``zero_init`` starts it at
    zero (flax's ``kernel_init=zeros``)."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True,
                 activation: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None,
                 zero_init: bool = False):
        super().__init__(n_in, n_out, bias=bias)
        self.activation = activation
        with torch.no_grad():
            a = 0.0 if zero_init else (6.0 / (n_in + n_out)) ** 0.5
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


class Residual(nn.Module):
    """Pre-activation residual block: x + dense_1(dense_0(act(x))), with
    ``dense_1`` zero-initialised (``nn/base.py:83-94``)."""

    def __init__(self, features: int, activation: Callable = shifted_softplus,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.dense_0 = Dense(features, features, activation=activation,
                             generator=generator)
        self.dense_1 = Dense(features, features, zero_init=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.dense_1(self.dense_0(self.activation(x)))


class ResidualMLP(nn.Module):
    """``n_residual`` residual blocks, the activation and a Dense ``out``
    layer, zero-initialised with ``last_zero_init`` (``nn/base.py:97-112``).
    The blocks are ``residual_{i}``, the flax names."""

    def __init__(self, features: int, n_out: int, n_residual: int = 1,
                 activation: Callable = shifted_softplus,
                 last_zero_init: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.n_residual = n_residual
        for i in range(n_residual):
            self.add_module(f"residual_{i}",
                            Residual(features, activation, generator))
        self.out = Dense(features, n_out, generator=generator,
                         zero_init=last_zero_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_residual):
            x = getattr(self, f"residual_{i}")(x)
        return self.out(self.activation(x))
