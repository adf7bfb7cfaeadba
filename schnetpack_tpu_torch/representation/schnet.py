"""SchNet on the column-bucketed layout (the MD path).

Port of ``schnetpack_tpu/representation/schnet.py`` on its column path
(``schnet.py:131-216, 56-69``): embedding (a plain table or a
``NuclearEmbedding``, plus the electronic embeddings asked for) -> the
raw-phi geometry, once per forward and differentiable in the positions
(``colblock_geo.column_geometry_raw``) -> n_interactions x (in2f -> fused
cfconv -> f2out_0 (ssp) -> f2out_1, residual add) -> scalar_representation
[A', F].  Forces come from autograd: the three cfconv backwards (K10) add
their geometry cotangents, and the geometry backward (K8) turns the sum
into dR.  With ``shared_interactions`` one block (flax name
``interaction_shared``, here ``interactions.0``) runs n_interactions times.

The basis is a ``GaussianRBF`` (any ``start``) and the cutoff the cosine
cutoff, as the JAX column path requires.  A trainable basis
(``schnet.py:155-168``) makes its centers and widths parameters: the
geometry is then the plain raw-phi twin of K5 (``colblock_geo.
geo_fwd_plain``) under autograd, as the JAX package takes
``column_geometry_xla`` there, and K10's geometry cotangent reaches the
centers, the widths and R through it.

The filter network's Dense layers (``filter_0`` [B -> F], ``filter_1``
[F -> F]) are ``nn.Linear`` modules; the cfconv op takes their weights
transposed, in flax's [in, out] layout.  ``SchNetInteraction.columns``
is the JAX block's generic column aggregate (``schnet.py:84-92``), which
FieldSchNet runs: the filter network in plain Dense layers on a given
basis, then the gather (K11), the product and the fold (K14).  The flat
and dense layouts are not ported and raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import properties
from ..nn.base import Dense
from ..nn.embedding import add_embeddings, embed_atoms
from ..nn.radial import GaussianRBF
from ..ops.activations import shifted_softplus
from ..ops.colblock import ColRefs
from ..ops.colblock_geo import column_geometry_raw, geo_fwd_plain
from ..ops.colblock_select import column_fold_op, column_gather_op
from ..ops.radial import gaussian_rbf_table
from ..ops.schnet_columns import schnet_cfconv_columns


class SchNetInteraction(nn.Module):
    """One continuous-filter convolution block (``SchNetInteraction``)."""

    def __init__(self, n_atom_basis: int, n_rbf: int, n_filters: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        F, A = n_filters, n_atom_basis
        self.filter_0 = Dense(n_rbf, F, generator=generator)
        self.filter_1 = Dense(F, F, generator=generator)
        self.in2f = Dense(A, F, bias=False, generator=generator)
        self.f2out_0 = Dense(F, A, activation=shifted_softplus,
                             generator=generator)
        self.f2out_1 = Dense(A, A, generator=generator)

    def forward(self, x, geo, refs: ColRefs):
        """The fused cfconv (K9/K10) on the raw-phi geometry ``geo``."""
        agg = schnet_cfconv_columns(
            self.in2f(x), geo, self.filter_0.weight.t(), self.filter_0.bias,
            self.filter_1.weight.t(), self.filter_1.bias, refs)
        return self.f2out_1(self.f2out_0(agg))

    def columns(self, x, f_ij, rcut_ij, refs: ColRefs):
        """The generic column aggregate on the basis ``f_ij`` [nx, ny,
        Ktot, B] and the cutoff ``rcut_ij`` [nx, ny, Ktot]: W = filter
        network * rcut, then fold(gather(in2f(x)) * W) by K11 and K14."""
        W = self.filter_1(shifted_softplus(self.filter_0(f_ij)))
        W = W * rcut_ij[..., None]
        hj = column_gather_op(self.in2f(x), refs)
        agg = column_fold_op(hj * W, refs)
        return self.f2out_1(self.f2out_0(agg))


class SchNet(nn.Module):
    """SchNet representation -> scalar_representation [A', F]."""

    #: its geometry comes from the positions (K5), never from ``col_rij``
    reads_column_rij = False

    def __init__(self, n_atom_basis: int = 128, n_interactions: int = 3,
                 n_rbf: int = 20, cutoff: float = 5.0,
                 n_filters: Optional[int] = None,
                 shared_interactions: bool = False, max_z: int = 100,
                 radial_basis: Optional[nn.Module] = None,
                 nuclear_embedding: bool = False,
                 electronic_embeddings: tuple = (),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        F = n_atom_basis
        self.radial_basis = (GaussianRBF(n_rbf, cutoff) if radial_basis is None
                             else radial_basis)
        if not isinstance(self.radial_basis, GaussianRBF):
            raise NotImplementedError(
                "the SchNet column path requires a GaussianRBF")
        rb = self.radial_basis
        self.n_atom_basis = F
        self.n_rbf = rb.n_rbf
        self.n_interactions = n_interactions
        self.cutoff = float(cutoff)
        add_embeddings(self, F, max_z, nuclear_embedding,
                       electronic_embeddings, generator)
        self.interactions = nn.ModuleList(
            SchNetInteraction(F, rb.n_rbf, n_filters or F, generator)
            for _ in range(1 if shared_interactions else n_interactions))
        self.register_buffer(
            "cw", None if rb.trainable
            else gaussian_rbf_table(rb.n_rbf, rb.cutoff, rb.start),
            persistent=False)

    def _geometry(self, R, coff_fm, refs: ColRefs):
        """The raw-phi geometry [nx, ny, B+4, Ktot]: K5/K8 for a fixed
        basis, the plain twin under autograd for a trainable one."""
        if self.cw is not None:
            return column_geometry_raw(R, coff_fm, refs, self.cw,
                                       self.cutoff)
        rb = self.radial_basis
        cw = torch.stack([rb.centers, -0.5 / rb.widths ** 2], dim=1)
        return geo_fwd_plain(R, coff_fm, refs, cw, self.cutoff, with_d=False,
                             raw_phi=True)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        if properties.cell_qcol not in inputs:
            raise NotImplementedError(
                "the port implements SchNet on the column layout only "
                "(inputs need the cell_qcol/cell_dcol/cell_coff_fm keys)")
        R = inputs[properties.R]
        qcol = inputs[properties.cell_qcol]
        P = R.shape[0] // (qcol.shape[0] * qcol.shape[1])
        refs = ColRefs(qcol, inputs[properties.cell_dcol], P,
                       tuple(inputs[properties.cell_ksz]))
        geo = self._geometry(R, inputs[properties.cell_coff_fm], refs)
        x = embed_atoms(self, inputs)
        for t in range(self.n_interactions):
            x = x + self.interactions[t % len(self.interactions)](x, geo, refs)
        inputs[properties.scalar_representation] = x
        return inputs
