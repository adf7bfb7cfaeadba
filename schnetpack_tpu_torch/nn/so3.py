"""SO(3)-equivariant layers (port of ``schnetpack_tpu/nn/so3.py``).

Feature layout ``[A, (lmax+1)^2, F]`` as in the JAX package.  The
convolution takes the edges of any layout (``atomistic.distances.
edge_layout``): on the column layout the gather of the source features
and the fold of the messages go through K11/K14 (``ops/
colblock_select.py``); on the dense layout they are ``x[nbh_idx]`` (or
``neighbor_gather`` with a reverse map) and a sum over K, on the flat
layout ``x[idx_j]`` and a segment sum (``so3.py:93-105``).  The per-edge
CG algebra is plain PyTorch, as it is XLA in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..atomistic.distances import as_edges
from ..ops import so3 as so3_ops
from .base import Dense


class RealSphericalHarmonics(nn.Module):
    def __init__(self, lmax: int):
        super().__init__()
        self.lmax = lmax

    def forward(self, directions: torch.Tensor) -> torch.Tensor:
        return so3_ops.real_spherical_harmonics(directions, self.lmax)


class SO3TensorProduct(nn.Module):
    """y = CG(x1, x2) elementwise over atoms and features."""

    def __init__(self, lmax: int):
        super().__init__()
        self.lmax = lmax
        self.register_buffer("cg", so3_ops.cg_dense(lmax), persistent=False)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return so3_ops.so3_tensor_product(x1, x2, self.cg)


def cg_message(ylm: torch.Tensor, Wl: torch.Tensor, xj: torch.Tensor,
               cg_deg: torch.Tensor) -> torch.Tensor:
    """Per-edge CG message msg[e, r, f] = sum_pq cg[p, q, r] W_l(p)[e, f]
    Y_p[e] xj[e, q, f] for ylm [..., n_lm], Wl [..., L, F] and xj [...,
    n_lm, F] (``einsum("pqr,xykpf,xykqf->xykrf", cg, WY, xj)``).

    Regrouped so that nothing of shape [edges, n_lm, n_lm, F] exists:
    M[e, r, (l, q)] = sum over p of degree l of cg[p, q, r] Y_p[e]
    (``ops.so3.cg_by_degree``; n_lm * L * n_lm scalars per edge) and
    U[e, (l, q), f] = W_l[e, f] xj[e, q, f], then msg = M @ U, one batched
    n_lm x (L n_lm) by (L n_lm) x F product: three passes over an [edges,
    L n_lm, F] tensor forward, against a dozen for a product per degree."""
    lead = xj.shape[:-2]
    n, F = xj.shape[-2:]
    L = Wl.shape[-2]
    M = (ylm.reshape(-1, n) @ cg_deg).reshape(-1, n, L * n)
    U = Wl.reshape(-1, L, 1, F) * xj.reshape(-1, 1, n, F)
    return torch.bmm(M, U.reshape(-1, L * n, F)).reshape(lead + (n, F))


class SO3Convolution(nn.Module):
    """Pairwise CG convolution: msg = W_l(d) * CG(x_j, Y(dir)), summed per
    destination atom.  Radial filters are per degree l of the Ylm slot,
    broadcast over m."""

    def __init__(self, lmax: int, n_atom_basis: int, n_radial: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lmax = lmax
        self.n_atom_basis = n_atom_basis
        self.filternet = Dense(n_radial, (lmax + 1) * n_atom_basis,
                               generator=generator)
        self.register_buffer("cg_deg", so3_ops.cg_by_degree(lmax),
                             persistent=False)

    def forward(self, x: torch.Tensor, radial_ij: torch.Tensor,
                dir_ij: torch.Tensor, cutoff_ij: torch.Tensor,
                edges) -> torch.Tensor:
        """x [A, n_lm, F] and the per-edge inputs [E..., .] of ``edges``
        (an edges object of ``atomistic.distances``, or ``ColRefs``)."""
        edges = as_edges(edges)
        F = x.shape[-1]
        ylm = so3_ops.real_spherical_harmonics(dir_ij, self.lmax)
        Wl = self.filternet(radial_ij)
        Wl = Wl.reshape(Wl.shape[:-1] + (self.lmax + 1, F)) \
            * cutoff_ij[..., None, None]
        return edges.fold(cg_message(ylm, Wl, edges.gather(x), self.cg_deg))


class SO3ParametricGatedNonlinearity(nn.Module):
    """x_lm <- x_lm * sigmoid(W x_00 + b), per degree l."""

    def __init__(self, n_in: int, lmax: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_in = n_in
        self.lmax = lmax
        self.scaling = Dense(n_in, (lmax + 1) * n_in, generator=generator)
        self.register_buffer(
            "deg", torch.as_tensor(so3_ops.degree_index(lmax)),
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.scaling(x[:, 0, :]).reshape(-1, self.lmax + 1, self.n_in)
        return x * torch.sigmoid(h[:, self.deg])


class SO3GatedNonlinearity(nn.Module):
    """Non-parametric gate by the scalar channel."""

    def __init__(self, lmax: int):
        super().__init__()
        self.lmax = lmax

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(x[:, 0:1, :])
