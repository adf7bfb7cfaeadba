"""PaiNN on every layout: the column-bucketed and 27-cell layouts (the
MD paths, on the CUDA kernels) and the flat and dense layouts (plain
PyTorch).

Port of ``schnetpack_tpu/representation/painn.py``: embedding ->
n_interactions x (context MLP ctx_0/ctx_1 -> message -> residual +
mixing) -> scalar features q [A', F] and vector features mu [A', 3, F].
On the column and cell paths ``mu`` stays flat [A', 3F] between blocks,
the kernels' layout, and the residual add is fused into the mixing
kernels (K3/K4).

Inputs without the column or cell keys take the JAX package's flat or
dense branch (``painn.py:375-392``), for any radial basis and cutoff:
from the displacements of ``atomistic.PairwiseDistances`` (``nbh_rij``
[A, K, 3] where the inputs hold it, else the flat ``Rij`` [P, 3]), the
safe distance, the direction, the cutoff times ``nbh_mask`` or
``pair_mask``, and the basis; each interaction's filter is (phi @ W +
b) * fcut from the same ``FW_aug`` rows the kernels read, and its
message gathers [x, mu] to the edges and sums them per center
(``painn.py:118-139``: ``x[nbh_idx]``, or ``neighbor_gather`` with a
reverse map, and a sum over K; ``x[idx_j]`` and ``segment_sum``).  The
mixing is the generic [A, 3, F] branch (``painn.py:236-260``) on the
parameters K3/K4 read.  These paths launch no kernel of this package.

Inputs with ``cell_qidx`` (``CellBlockNeighborListMD(layout="atom")``)
take the 27-cell path (``painn.py:375-382, 403-410, 450``) for any radial
basis and cutoff: from the displacements ``nbh_rij`` [A', K, 3] of
``atomistic.PairwiseDistances``, the safe distance, the direction, the
cutoff times ``nbh_mask`` and the basis give rbf_aug = [phi*fcut, fcut]
in plain torch with autograd, and every interaction runs the message
kernels K18/K19 (``ops/painn_fused.py``) on xmu = [x, mu].  Column inputs
follow the JAX package's dispatch (``painn.py:312-318``):

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

``pieces`` is the JAX package's reduced-precision feature mode
(``ops/precision.py``; ``PIECES``, set there by the calculator's
``precision``) as an argument: 3 (f32, the default), 2 ("mixed") or 1
("bf16") runs the ``full`` and ``hybrid`` messages in the kernels'
instances of that mode (their twins on the CPU).  The flat and dense
layouts run no kernel and ignore it, as the JAX package's do.  The
row-9 column path, the slab path and the 27-cell path raise
``ReducedPrecisionPathError`` at ``pieces != 3``: there the JAX mode
rounds the gathered positions themselves.

Column inputs with ``cell_shard`` (the slab path of ``parallel/columns.py``)
take the JAX package's ``"column"`` context (``painn.py:302-311, 368-373,
403-410, 438-448``) for any basis and cutoff: the plain per-edge geometry
from ``col_rij`` (the cutoff times ``cell_emask``), edge-major rbf_aug
[nx, ny, Ktot, B+1] and directions [nx, ny, Ktot, 3] with autograd, and
every interaction's message on xmu = [x, mu] through row 12 (K20/K21,
``ops/colblock_edge.py``) in the refs' halo mode.

Parameters are held the way the kernels read them: ``FW_aug`` [T, B+1, 3F]
(the filter network's weights per interaction with its bias as the last
row, ``painn.py:403-416``) and, per mixing block, ``kmix`` [F, 2F],
``k0`` [2F, F], ``b0``, ``k1`` [F, 3F], ``b1`` (flax kernel layout); a
trainable basis adds ``radial_basis.centers`` and ``radial_basis.widths``.

The JAX package's model options (``painn.py:394-490``) are ported:
``shared_filters`` keeps one [B, 3F] filter network, ``FW_aug`` [1, B+1,
3F], whose one slice every interaction's message reads (autograd sums the
T cotangents into it); ``shared_interactions`` keeps one context MLP and
one mixing block (flax ``interaction_shared``, ``mixing_shared``; here
``interactions.0``, ``mixing.0``) that run n_interactions times;
``nuclear_embedding`` and ``electronic_embeddings`` as in SchNet
(``nn/embedding.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import properties
from ..atomistic.distances import (
    cell_refs, column_refs, edge_geometry, edge_layout,
)
from ..nn.base import Dense
from ..nn.cutoff import CosineCutoff
from ..nn.embedding import add_embeddings, embed_atoms
from ..nn.radial import GaussianRBF
from ..ops.activations import ACTIVATIONS
from ..ops.colblock import ColRefs
from ..ops.colblock_edge import painn_message_columns
from ..ops.colblock_geo import column_geometry_packed
from ..ops.colblock_message import (
    painn_message_columns_fm, painn_message_columns_fm_geores,
    painn_message_columns_full_fused,
)
from ..ops.painn_fused import painn_message_cellblock
from ..ops.painn_mixing import painn_mixing_fused
from ..ops.precision import check_pieces, refuse
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

    def plain(self, q, mu, dq, dmu):
        """The residual add and the mixing on mu [A, 3, F] in plain
        PyTorch (``painn.py:236-260``), on the kernels' parameters."""
        F = q.shape[1]
        q, mu = q + dq, mu + dmu
        mu_V = mu @ self.kmix[:, :F]
        mu_W = mu @ self.kmix[:, F:]
        mu_Vn = torch.sqrt((mu_V * mu_V).sum(-2) + self.epsilon)
        x = ACTIVATIONS[self.activation](
            q @ self.k0[:F] + mu_Vn @ self.k0[F:] + self.b0)
        d_q, d_mu, d_qmu = (x @ self.k1 + self.b1).split(F, dim=-1)
        return (q + d_q + d_qmu * (mu_V * mu_W).sum(-2),
                mu + d_mu[:, None, :] * mu_W)


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
                 nuclear_embedding: bool = False,
                 electronic_embeddings: tuple = (),
                 pieces: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        #: one interaction block for all (flax ``*_shared``)
        self.shared_interactions = shared_interactions
        #: the feature precision of the full and hybrid column messages
        #: (3 f32, 2 mixed, 1 bf16; ``ops/precision.py``)
        self.pieces = check_pieces(pieces)
        if fuse not in ("hybrid", "full"):
            raise ValueError(f"fuse must be 'hybrid' or 'full', got {fuse!r}")
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
        #: whether the unsharded column path reads ``col_rij`` (the fused
        #: paths' kernels take the positions)
        self.reads_column_rij = not fused
        self.n_atom_basis = F
        self.n_rbf = rb.n_rbf
        self.n_interactions = n_interactions
        self.cutoff = float(self.cutoff_fn.cutoff if fused else cutoff)
        add_embeddings(self, F, max_z, nuclear_embedding,
                       electronic_embeddings, generator)
        n_filt = 1 if shared_filters else n_interactions
        w = _xavier((self.n_rbf, n_filt * 3 * F), generator)
        self.FW_aug = nn.Parameter(torch.cat(
            [w.reshape(self.n_rbf, n_filt, 3 * F),
             torch.zeros(1, n_filt, 3 * F)], 0).transpose(0, 1)
            .contiguous())
        n_blocks = 1 if shared_interactions else n_interactions
        self.interactions = nn.ModuleList(
            PaiNNInteraction(F, activation, generator)
            for _ in range(n_blocks))
        self.mixing = nn.ModuleList(
            PaiNNMixing(F, activation, epsilon, generator)
            for _ in range(n_blocks))
        self.register_buffer(
            "cw", gaussian_rbf_table(rb.n_rbf, rb.cutoff, rb.start)
            if fused else None, persistent=False)

    def _edge_geometry(self, inputs, key: str, mask: torch.Tensor):
        """rbf_aug [..., B+1] = [phi*fcut, fcut] and dir [..., 3] from the
        per-edge displacements ``inputs[key]``, with their autograd graph,
        for any basis and cutoff; ``mask`` zeroes the padded slots
        (``painn.py:368-382, 393, 403-410``)."""
        if key not in inputs:
            raise ValueError(
                f"PaiNN with {type(self.radial_basis).__name__} and "
                f"{type(self.cutoff_fn).__name__} on this layout reads the "
                f"per-edge displacements {key}: run "
                "atomistic.PairwiseDistances as an input module")
        phi, fcut, dirs = self._basis(inputs[key], mask)
        fcut = fcut[..., None]
        return torch.cat([phi * fcut, fcut], dim=-1), dirs

    def _basis(self, Rij, mask):
        """(phi, fcut * mask, dir) of per-edge displacements."""
        d, dirs = edge_geometry(Rij)
        return (self.radial_basis(d),
                self.cutoff_fn(d) * mask.to(Rij.dtype), dirs)

    def _plain_message(self, inputs):
        """The message of the flat and dense layouts (``painn.py:118-139,
        375-392``): dq [A, F] and dmu [A, 3, F] from x [A, 3F] and mu
        [A, 3, F]."""
        edges, Rij, mask = edge_layout(inputs)
        phi, fcut, dirs = self._basis(Rij, mask)
        F = self.n_atom_basis

        def message(x, mu, FW_aug):
            W = (phi @ FW_aug[:-1] + FW_aug[-1]) * fcut[..., None]
            dq, dmuR, dmumu = (edges.gather(x) * W).split(F, dim=-1)
            dmu = (dmuR[..., None, :] * dirs[..., None]
                   + dmumu[..., None, :] * edges.gather(mu))
            return edges.fold(dq), edges.fold(dmu)
        return message

    def _column_geometry(self, inputs, refs: ColRefs) -> torch.Tensor:
        """[phi*fcut, fcut, dir] [nx, ny, B+4, Ktot] from ``col_rij``, with
        its autograd graph (``painn.py:368-373, 438-446``)."""
        rbf_aug, dirs = self._edge_geometry(inputs, properties.col_rij,
                                            refs.qcol >= 0)
        return torch.cat([rbf_aug, dirs], dim=-1).movedim(-1, 2)

    def _cell_geometry(self, inputs):
        """rbf_aug [A', K, B+1] and dir [A', K, 3] from ``nbh_rij``
        (``painn.py:375-382``)."""
        return self._edge_geometry(inputs, properties.nbh_rij,
                                   inputs[properties.nbh_mask])

    def set_pieces(self, pieces: int, layout: str):
        """The calculator's feature mode on its blocked layout ``layout``
        (``ops.precision.set_pieces``): the mode of the full and hybrid
        messages on ``"cellblock"``, else ``ReducedPrecisionPathError``."""
        if layout != "cellblock" or self.path not in ("full", "hybrid"):
            refuse(f"PaiNN ({self.path}) on {layout!r}", pieces)
        self.pieces = check_pieces(pieces)

    def _exact_only(self, path: str):
        """Raise on a path where the JAX mode rounds the positions."""
        refuse(f"PaiNN on {path}", self.pieces)

    def _cell_message(self, inputs):
        """The message of the 27-cell path: K18/K19 on [x, mu]."""
        self._exact_only("the 27-cell layout")
        refs = cell_refs(inputs)
        rbf_aug, dirs = self._cell_geometry(inputs)

        def message(x, mu, FW_aug):
            return painn_message_cellblock(torch.cat([x, mu], dim=-1),
                                           rbf_aug, dirs, FW_aug, refs)
        return message

    def _column_message(self, inputs):
        """The message of the column path, in the form ``self.path``
        picks, or on a slab the row-12 message."""
        R = inputs[properties.R]
        refs = column_refs(inputs)
        if refs.shard_axis is not None:
            self._exact_only("the slab path")
            rbf_aug, dirs = self._edge_geometry(
                inputs, properties.col_rij, inputs[properties.cell_emask])
            return lambda x, mu, FW_aug: painn_message_columns(
                torch.cat([x, mu], dim=-1), rbf_aug, dirs, FW_aug, refs)
        coff_fm = inputs[properties.cell_coff_fm]
        if self.path == "column_fm":
            self._exact_only(
                f"the row-9 column path ({type(self.radial_basis).__name__}"
                f", {type(self.cutoff_fn).__name__})")
            geo = self._column_geometry(inputs, refs).contiguous()
            return lambda x, mu, FW_aug: painn_message_columns_fm(
                x, mu, geo, FW_aug, refs)
        if self.path == "hybrid":
            with torch.no_grad():
                geo = column_geometry_packed(R, coff_fm, refs, self.cw,
                                             self.cutoff, with_d=True)
            return lambda x, mu, FW_aug: painn_message_columns_fm_geores(
                x, mu, R, geo, FW_aug, coff_fm, self.cw, refs, self.cutoff,
                self.pieces)
        return lambda x, mu, FW_aug: painn_message_columns_full_fused(
            x, mu, R, FW_aug, coff_fm, self.cw, refs, self.cutoff,
            self.pieces)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        F = self.n_atom_basis
        blocked = (properties.cell_qcol in inputs
                   or properties.cell_qidx in inputs)
        if blocked:
            message = (self._column_message(inputs)
                       if properties.cell_qcol in inputs
                       else self._cell_message(inputs))
        else:
            message = self._plain_message(inputs)
        q = embed_atoms(self, inputs)
        mu = q.new_zeros((q.shape[0], 3 * F) if blocked
                         else (q.shape[0], 3, F))
        for t in range(self.n_interactions):
            b = t % len(self.interactions)
            dq, dmu = message(self.interactions[b](q), mu,
                              self.FW_aug[t % len(self.FW_aug)])
            mix = self.mixing[b]
            q, mu = (mix(q, mu, dq, dmu) if mu.ndim == 2
                     else mix.plain(q, mu, dq, dmu))
        inputs[properties.scalar_representation] = q
        inputs[properties.vector_representation] = mu.reshape(-1, 3, F)
        return inputs
