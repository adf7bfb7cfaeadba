"""SchNet on every layout: the column-bucketed layout (the MD path, on
the CUDA kernels), and the flat, dense and 27-cell layouts (plain
PyTorch, the 27-cell layout's displacements from K16/K17).

Port of ``schnetpack_tpu/representation/schnet.py``.  On the column path
(``schnet.py:131-216, 56-69``): embedding (a plain table or a
``NuclearEmbedding``, plus the electronic embeddings asked for) -> the
raw-phi geometry, once per forward and differentiable in the positions
(``colblock_geo.column_geometry_raw``) -> n_interactions x (in2f -> fused
cfconv -> f2out_0 (ssp) -> f2out_1, residual add) -> scalar_representation
[A', F].  Forces come from autograd: the three cfconv backwards (K10) add
their geometry cotangents, and the geometry backward (K8) turns the sum
into dR.  With ``shared_interactions`` one block (flax name
``interaction_shared``, here ``interactions.0``) runs n_interactions times.

The column path's basis is a ``GaussianRBF`` (any ``start``) with the
cosine cutoff, as the JAX column path requires; other bases raise there.
A trainable basis (``schnet.py:155-168``) makes its centers and widths
parameters: the geometry is then the plain raw-phi twin of K5
(``colblock_geo.geo_fwd_plain``) under autograd, as the JAX package takes
``column_geometry_xla`` there, and K10's geometry cotangent reaches the
centers, the widths and R through it.

Inputs without the column keys take the JAX package's dense or flat
branch (``schnet.py:84-103, 125, 178-190``) for any radial basis: from
the displacements of ``atomistic.PairwiseDistances`` (``nbh_rij`` where
the inputs hold it, else ``Rij``), the safe distance, the basis and the
cosine cutoff times ``nbh_mask`` or ``pair_mask``; each block's filter
network on the basis, and the aggregate ``fold(gather(in2f(x)) * W)``
(``SchNetInteraction.aggregate``).  On the 27-cell layout
(``cellblock_atom``) that is the dense branch: ``nbh_rij`` comes from K16
(its VJP K17), and ``nbh_idx``, which has no reverse map there, is a
plain gather.

The filter network's Dense layers (``filter_0`` [B -> F], ``filter_1``
[F -> F]) are ``nn.Linear`` modules; the cfconv op takes their weights
transposed, in flax's [in, out] layout.  ``aggregate`` on a column
layout is the JAX block's generic column aggregate (``schnet.py:84-92``),
which FieldSchNet runs: the gather (K11), the product and the fold (K14).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import properties
from ..atomistic.distances import as_edges, edge_geometry, edge_layout
from ..nn.base import Dense
from ..nn.cutoff import CosineCutoff
from ..nn.embedding import add_embeddings, embed_atoms
from ..nn.radial import GaussianRBF
from ..ops.activations import shifted_softplus
from ..ops.colblock import ColRefs
from ..ops.colblock_geo import column_geometry_raw, geo_fwd_plain
from ..ops.precision import refuse
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

    def aggregate(self, x, f_ij, rcut_ij, edges):
        """The generic aggregate on the basis ``f_ij`` [E..., B] and the
        cutoff ``rcut_ij`` [E...] of a layout's edges (``ColRefs``: K11
        and K14): W = filter network * rcut, then fold(gather(in2f(x)) *
        W)."""
        edges = as_edges(edges)
        W = self.filter_1(shifted_softplus(self.filter_0(f_ij)))
        W = W * rcut_ij[..., None]
        agg = edges.fold(edges.gather(self.in2f(x)) * W)
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
        #: one interaction block for all (flax ``*_shared``)
        self.shared_interactions = shared_interactions
        F = n_atom_basis
        self.radial_basis = (GaussianRBF(n_rbf, cutoff) if radial_basis is None
                             else radial_basis)
        rb = self.radial_basis
        gauss = isinstance(rb, GaussianRBF)
        self.cutoff_fn = CosineCutoff(cutoff)
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
            "cw", gaussian_rbf_table(rb.n_rbf, rb.cutoff, rb.start)
            if gauss and not rb.trainable else None, persistent=False)

    def set_pieces(self, pieces: int, layout: str):
        """The calculator's feature mode on its blocked layout ``layout``
        (``ops.precision.set_pieces``): a no-op on ``"cellblock"`` (the JAX
        package's cfconv kernels read no ``PIECES``),
        ``ReducedPrecisionPathError`` on ``"cellblock_atom"``, whose
        gather rounds the positions there."""
        if layout == "cellblock_atom":
            refuse(f"SchNet on {layout!r}", pieces)

    def _geometry(self, R, coff_fm, refs: ColRefs):
        """The raw-phi geometry [nx, ny, B+4, Ktot]: K5/K8 for a fixed
        basis, the plain twin under autograd for a trainable one."""
        if not isinstance(self.radial_basis, GaussianRBF):
            raise NotImplementedError(
                "the SchNet column path requires a GaussianRBF")
        if self.cw is not None:
            return column_geometry_raw(R, coff_fm, refs, self.cw,
                                       self.cutoff)
        rb = self.radial_basis
        cw = torch.stack([rb.centers, -0.5 / rb.widths ** 2], dim=1)
        return geo_fwd_plain(R, coff_fm, refs, cw, self.cutoff, with_d=False,
                             raw_phi=True)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        if properties.cell_qcol not in inputs:
            return self._plain(inputs)
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

    def _plain(self, inputs: Dict[str, torch.Tensor]):
        """The dense and flat layouts (``schnet.py:84-103, 178-190``)."""
        edges, Rij, mask = edge_layout(inputs)
        d, _ = edge_geometry(Rij)
        f_ij = self.radial_basis(d)
        rcut_ij = self.cutoff_fn(d) * mask.to(d.dtype)
        x = embed_atoms(self, inputs)
        for t in range(self.n_interactions):
            block = self.interactions[t % len(self.interactions)]
            x = x + block.aggregate(x, f_ij, rcut_ij, edges)
        inputs[properties.scalar_representation] = x
        return inputs
