"""PaiNN on the column-bucketed layout (the MD path).

Port of ``schnetpack_tpu/representation/painn.py`` on its column path:
embedding -> n_interactions x (context MLP ctx_0/ctx_1 -> fused message ->
fused residual + mixing) -> scalar features q [A', F] and vector features
mu [A', 3, F].  ``mu`` stays flat [A', 3F] between blocks, the kernels'
layout.  The message form follows the JAX package's dispatch
(``painn.py:312-318``):

* a fixed ``GaussianRBF`` (any ``start``) with a ``CosineCutoff`` takes
  the fused geometry, in the form ``fuse`` picks (the JAX package's
  ``FUSE``, ``ops/cellblock.py:80-92``, as an argument):

  * ``"hybrid"``: the packed geometry is computed once per forward under
    ``torch.no_grad()`` (the JAX ``stop_gradient``, ``painn.py:340-358``)
    and every interaction's message reads it, forward and backward; dR
    comes out of the message backward only;
  * ``"full"``: the geometry is recomputed inside both message kernels.

  The default is ``"full"``, unlike the JAX package's ``"hybrid"``: on the
  H100 at the 10,976-atom bench shapes the full step measured 0.8-3%
  faster (PERF.md, section 6); the TPU's reason for hybrid, a geometry
  recompute that cost more than the geo reads, does not hold there.
* any other radial basis or cutoff (a trainable Gaussian, ``BesselRBF``,
  ``GaussianRBFCentered``, ``MollifierCutoff``, ``SwitchFunction``) takes
  the plain per-edge geometry (``painn.py:368-373, 438-446``): from the
  displacements ``col_rij`` of ``atomistic.PairwiseDistances``, the safe
  distance, the direction, the cutoff times the edge mask and the basis
  are packed into a geo [nx, ny, B+4, Ktot] = [phi*fcut, fcut, dir] that
  autograd differentiates.  The message backward (K15) returns its
  cotangent, and autograd carries it to the positions and to trainable
  basis parameters.

Parameters are held the way the kernels read them: ``FW_aug`` [T, B+1, 3F]
(the filter network's weights per interaction with its bias as the last
row, ``painn.py:403-416``) and, per mixing block, ``kmix`` [F, 2F],
``k0`` [2F, F], ``b0``, ``k1`` [F, 3F], ``b1`` (flax kernel layout); a
trainable basis adds ``radial_basis.centers`` and ``radial_basis.widths``.
Shared filters and shared interactions raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import properties
from ..atomistic.distances import column_refs
from ..nn.base import Dense
from ..nn.cutoff import CosineCutoff
from ..nn.radial import GaussianRBF
from ..ops.activations import ACTIVATIONS
from ..ops.colblock import ColRefs
from ..ops.colblock_geo import column_geometry_packed
from ..ops.colblock_message import (
    painn_message_columns_fm, painn_message_columns_fm_geores,
    painn_message_columns_full_fused,
)
from ..ops.math import safe_norm
from ..ops.painn_mixing import painn_mixing_fused
from ..ops.radial import gaussian_rbf_table


class PaiNNInteraction(nn.Module):
    """Context MLP of the inter-atomic block (``PaiNNInteraction``); the
    message itself is the fused op that ``PaiNN`` picks."""

    def __init__(self, n_atom_basis: int, activation: str = "ssp",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        F = n_atom_basis
        self.ctx_0 = Dense(F, F, activation=ACTIVATIONS[activation],
                           generator=generator)
        self.ctx_1 = Dense(F, 3 * F, generator=generator)

    def forward(self, q):
        """The context x [A', 3F] of the message."""
        return self.ctx_1(self.ctx_0(q))


class PaiNNMixing(nn.Module):
    """Intra-atomic block with the residual add fused (``PaiNNMixing``)."""

    def __init__(self, n_atom_basis: int, activation: str = "ssp",
                 epsilon: float = 1e-8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        F = n_atom_basis
        self.activation = activation
        self.epsilon = float(epsilon)
        self.kmix = nn.Parameter(_xavier((F, 2 * F), generator))
        self.k0 = nn.Parameter(_xavier((2 * F, F), generator))
        self.b0 = nn.Parameter(torch.zeros(F))
        self.k1 = nn.Parameter(_xavier((F, 3 * F), generator))
        self.b1 = nn.Parameter(torch.zeros(3 * F))

    def forward(self, q, mu, dq, dmu):
        return painn_mixing_fused(q, mu, dq, dmu, self.kmix, self.k0,
                                  self.b0, self.k1, self.b1, self.epsilon,
                                  self.activation)


def _xavier(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Xavier-uniform [fan_in, fan_out] (flax kernel layout)."""
    a = (6.0 / (shape[0] + shape[1])) ** 0.5
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * a


class PaiNN(nn.Module):
    """PaiNN representation -> scalar_representation [A', F] and
    vector_representation [A', 3, F]."""

    def __init__(self, n_atom_basis: int = 128, n_interactions: int = 3,
                 n_rbf: int = 20, cutoff: float = 5.0, max_z: int = 100,
                 activation: str = "ssp", epsilon: float = 1e-8,
                 fuse: str = "full",
                 radial_basis: Optional[nn.Module] = None,
                 cutoff_fn: Optional[nn.Module] = None,
                 shared_interactions: bool = False,
                 shared_filters: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if fuse not in ("hybrid", "full"):
            raise ValueError(f"fuse must be 'hybrid' or 'full', got {fuse!r}")
        if shared_interactions or shared_filters:
            raise NotImplementedError(
                "the port's PaiNN has no shared interactions or filters")
        F = n_atom_basis
        self.radial_basis = (GaussianRBF(n_rbf, cutoff) if radial_basis is None
                             else radial_basis)
        self.cutoff_fn = (CosineCutoff(cutoff) if cutoff_fn is None
                          else cutoff_fn)
        rb = self.radial_basis
        fused = (isinstance(rb, GaussianRBF) and not rb.trainable
                 and isinstance(self.cutoff_fn, CosineCutoff))
        #: the message form: "full" or "hybrid" (fused geometry) or
        #: "column_fm" (differentiable geometry, K6/K15)
        self.path = fuse if fused else "column_fm"
        self.n_atom_basis = F
        self.n_rbf = rb.n_rbf
        self.cutoff = float(self.cutoff_fn.cutoff if fused else cutoff)
        self.embedding = nn.Embedding(max_z + 1, F)
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, F ** -0.5,
                                          generator=generator)
        w = _xavier((self.n_rbf, n_interactions * 3 * F), generator)
        self.FW_aug = nn.Parameter(torch.cat(
            [w.reshape(self.n_rbf, n_interactions, 3 * F),
             torch.zeros(1, n_interactions, 3 * F)], 0).transpose(0, 1)
            .contiguous())
        self.interactions = nn.ModuleList(
            PaiNNInteraction(F, activation, generator)
            for _ in range(n_interactions))
        self.mixing = nn.ModuleList(
            PaiNNMixing(F, activation, epsilon, generator)
            for _ in range(n_interactions))
        self.register_buffer(
            "cw", gaussian_rbf_table(rb.n_rbf, rb.cutoff, rb.start)
            if fused else None, persistent=False)

    def _column_geometry(self, inputs, refs: ColRefs) -> torch.Tensor:
        """[phi*fcut, fcut, dir] [nx, ny, B+4, Ktot] from ``col_rij``, with
        its autograd graph (``painn.py:368-373, 438-446``)."""
        if properties.col_rij not in inputs:
            raise ValueError(
                f"PaiNN with {type(self.radial_basis).__name__} and "
                f"{type(self.cutoff_fn).__name__} reads the per-edge "
                "displacements: run atomistic.PairwiseDistances as an input "
                "module")
        Rij = inputs[properties.col_rij]
        d = safe_norm(Rij)
        dirs = Rij / d[..., None]
        fcut = (self.cutoff_fn(d) * (refs.qcol >= 0).to(Rij.dtype))[..., None]
        phi = self.radial_basis(d)
        return torch.cat([phi * fcut, fcut, dirs], dim=-1).movedim(-1, 2)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        if properties.cell_qcol not in inputs:
            raise NotImplementedError(
                "the port implements PaiNN on the column layout only "
                "(inputs need the cell_qcol/cell_dcol/cell_coff_fm keys)")
        R = inputs[properties.R]
        refs = column_refs(inputs)
        coff_fm = inputs[properties.cell_coff_fm]
        geo = None
        if self.path == "column_fm":
            geo = self._column_geometry(inputs, refs).contiguous()
        elif self.path == "hybrid":
            with torch.no_grad():
                geo = column_geometry_packed(R, coff_fm, refs, self.cw,
                                             self.cutoff, with_d=True)
        F = self.n_atom_basis
        q = self.embedding(inputs[properties.Z])
        mu = q.new_zeros((q.shape[0], 3 * F))
        for t, (inter, mix) in enumerate(zip(self.interactions,
                                             self.mixing)):
            x, FW_aug = inter(q), self.FW_aug[t]
            if self.path == "column_fm":
                dq, dmu = painn_message_columns_fm(x, mu, geo, FW_aug, refs)
            elif self.path == "hybrid":
                dq, dmu = painn_message_columns_fm_geores(
                    x, mu, R, geo, FW_aug, coff_fm, self.cw, refs,
                    self.cutoff)
            else:
                dq, dmu = painn_message_columns_full_fused(
                    x, mu, R, FW_aug, coff_fm, self.cw, refs, self.cutoff)
            q, mu = mix(q, mu, dq, dmu)
        inputs[properties.scalar_representation] = q
        inputs[properties.vector_representation] = mu.reshape(-1, 3, F)
        return inputs
