"""Derivative helpers on ``torch.autograd`` (parity:
``schnetpack_tpu/nn/utils.py``, whose ``jax.jacrev`` compositions keep
the reference's call signatures).

``derivative_from_molecular`` is the Jacobian of a function's outputs
with respect to its inputs, one batched vector-Jacobian product over
every output element (``is_grads_batched``); ``derivative_from_atomic``
is the same Jacobian of an [A, 3] -> [A, 3] map with the blocks between
different molecules zeroed (a Hessian from a force function).
"""
from __future__ import annotations

from typing import Callable

import torch


def derivative_from_molecular(fn: Callable[[torch.Tensor], torch.Tensor],
                              inputs: torch.Tensor) -> torch.Tensor:
    """d fn / d inputs: [*out, *in]."""
    x = inputs.detach().requires_grad_(True)
    with torch.enable_grad():
        y = fn(x)
        eye = torch.eye(y.numel(), dtype=y.dtype, device=y.device)
        (jac,) = torch.autograd.grad(
            y, x, eye.reshape((-1,) + y.shape), is_grads_batched=True,
            allow_unused=True)
    if jac is None:
        return y.new_zeros(y.shape + x.shape)
    return jac.reshape(y.shape + x.shape)


def derivative_from_atomic(fn: Callable[[torch.Tensor], torch.Tensor],
                           inputs: torch.Tensor, idx_m: torch.Tensor,
                           n_molecules: int) -> torch.Tensor:
    """[A, 3, A, 3] Jacobian of ``fn`` with the cross-molecule blocks
    zeroed (``n_molecules`` is the reference's argument; the mask reads
    ``idx_m``)."""
    del n_molecules
    full = derivative_from_molecular(fn, inputs)
    same = (idx_m[:, None] == idx_m[None, :]).to(full.dtype)
    return full * same[:, None, :, None]


def replicate_module(module_factory: Callable, n: int, share_params: bool):
    """``n`` blocks from ``module_factory``; with ``share_params`` one block
    repeated (``torch.nn.ModuleList`` keeps one set of its parameters)."""
    if share_params:
        block = module_factory()
        return torch.nn.ModuleList([block] * n)
    return torch.nn.ModuleList(module_factory() for _ in range(n))
