"""FieldSchNet on every layout (port of
``schnetpack_tpu/representation/field_schnet.py:179-292``): SchNet whose
atoms also carry dipole features mu [A', 3, F] per external field.  From
the per-edge displacements of ``atomistic.PairwiseDistances`` come the
distance d, the Gaussian basis, the cosine cutoff times the layout's mask
and the pair vectors v_ij, UNNORMALISED.  Then:

* an initial dipole update from the embeddings (``:259-262``), and the
  nuclear magnetic moments' term where the magnetic field is a field and
  the inputs hold the moments (``:264-272``);
* n_interactions x (SchNet's generic aggregate
  (``SchNetInteraction.aggregate``) + the field interaction + the
  dipole-dipole interaction -> dq; q += dq; the dipole update from dq)
  (``:274-289``), whose last dipole update is not computed: nothing reads
  its mu (the JAX package's jit drops it as dead code);
* ``scalar_representation`` = q [A', F].

The layout is the column layout where the inputs hold it (``col_rij``
and the edge mask ``refs.qcol >= 0``); else the dense one (``nbh_rij``,
``nbh_mask``) only when the flat list carries no real pairs,
``idx_i.shape[0] <= 1`` (``field_schnet.py:228-236``); else the flat one
(``Rij``, ``pair_mask``).  On the column layout every gather of a
per-atom table is ``column_gather_op`` (K11, VJP K12) and every per-atom
sum ``column_fold_op`` (K14, VJP K13): at D = F (the SchNet aggregate's
in2f(q), the dipole update's transform(q)) and D = 3F (the gathered mu,
the folded dipole tensors), 15 gathers and 15 folds a forward at 5
interactions.  On the dense layout the gathers are ``x[nbh_idx]`` (the
JAX model reads no reverse map here, ``:142-143``) and the sums run over
K; on the flat layout ``x[idx_j]`` and segment sums (``:97, :157``).  The
SchNet blocks take the generic aggregate, not the fused cfconv (K9/K10),
as the JAX package's FieldSchNet does (``field_schnet.py:275-277``).

Per-atom fields are the inputs' per-molecule fields taken at ``idx_m``
clipped into range (zeros for a field the inputs lack, as in MD).  Where
the magnetic field is a field, ``nmm_embedding`` (default on) makes the
moments' embedding, which flax makes only when its first inputs hold
moments: a tree made without them loads into ``nmm_embedding=False``.  Module
and parameter names follow flax's, with the per-block modules in lists:
``interaction_t`` -> ``interactions.t``, ``field_inter_t`` ->
``field_inter.t``, ``dipole_inter_t`` -> ``dipole_inter.t``,
``dipole_update_t`` -> ``dipole_update.t``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from .. import properties
from ..atomistic.distances import as_edges, edge_layout
from ..nn.base import Dense
from ..nn.cutoff import CosineCutoff
from ..nn.radial import GaussianRBF
from ..ops.activations import shifted_softplus
from ..ops.math import safe_norm
from .schnet import SchNetInteraction


def _tag(field: str) -> str:
    return field.strip("_")


class FieldInteraction(nn.Module):
    """dq = sum over fields of Dense_act(mu . E) (``field_schnet.py:45-60``);
    one Dense ``f2out_{field}`` per field."""

    def __init__(self, n_atom_basis: int, external_fields: Sequence[str],
                 activation: Callable = shifted_softplus,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fields = tuple(external_fields)
        for f in self.fields:
            self.add_module(f"f2out_{_tag(f)}", Dense(
                n_atom_basis, n_atom_basis, activation=activation,
                generator=generator))

    def forward(self, mu: Dict[str, torch.Tensor],
                fields: Dict[str, torch.Tensor]) -> torch.Tensor:
        dq = 0.0
        for f in self.fields:
            v = (mu[f] * fields[f][:, :, None]).sum(1)
            dq = dq + getattr(self, f"f2out_{_tag(f)}")(v)
        return dq


class DipoleUpdate(nn.Module):
    """mu_i += sum_j transform(q)_j rcut_ij v_ij with the unnormalised pair
    vectors v_ij (``field_schnet.py:63-99``): the table [A', F] gathered,
    the products folded at [.., 3F]."""

    def __init__(self, n_atom_basis: int, external_fields: Sequence[str],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fields = tuple(external_fields)
        for f in self.fields:
            self.add_module(f"transform_{_tag(f)}", Dense(
                n_atom_basis, n_atom_basis, bias=False, generator=generator))

    def forward(self, q, mu: Dict[str, torch.Tensor], v_ij, rcut_ij,
                edges) -> Dict[str, torch.Tensor]:
        edges = as_edges(edges)
        out = {}
        for f in self.fields:
            qj = edges.gather(getattr(self, f"transform_{_tag(f)}")(q))
            dmu_ij = (qj * rcut_ij[..., None])[..., None, :] * v_ij[..., None]
            out[f] = mu[f] + edges.fold(dmu_ij)
        return out


class DipoleInteraction(nn.Module):
    """Scalar update from dipole-dipole interactions through the classical
    interaction tensor (``field_schnet.py:102-161``): per field a filter
    network (``filter_{field}_0`` with the activation, ``filter_{field}_1``
    zero-initialised), mu gathered [.., 3F], the tensor folded [.., 3F],
    and ``transform_{field}``.  d^5 is taken at max(d, 1e-2): a padded
    slot's d is ~0, where 1/d^5 would overflow before the cutoff zeroes
    the term."""

    def __init__(self, n_atom_basis: int, n_rbf: int,
                 external_fields: Sequence[str],
                 activation: Callable = shifted_softplus,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        F = n_atom_basis
        self.fields = tuple(external_fields)
        for f in self.fields:
            t = _tag(f)
            self.add_module(f"filter_{t}_0", Dense(
                n_rbf, F, activation=activation, generator=generator))
            self.add_module(f"filter_{t}_1", Dense(F, F, zero_init=True))
            self.add_module(f"transform_{t}", Dense(
                F, F, activation=activation, generator=generator))

    def forward(self, mu: Dict[str, torch.Tensor], f_ij, d_ij, v_ij, rcut_ij,
                edges) -> torch.Tensor:
        edges = as_edges(edges)
        dq = 0.0
        d5 = torch.clamp(d_ij, min=1e-2) ** 5
        for f in self.fields:
            t = _tag(f)
            W = getattr(self, f"filter_{t}_1")(
                getattr(self, f"filter_{t}_0")(f_ij))
            W = W * rcut_ij[..., None]
            mu_ij = edges.gather(mu[f])
            proj = (v_ij[..., None] * mu_ij).sum(-2, keepdim=True)
            tensor = (mu_ij * (d_ij ** 2)[..., None, None]
                      - 3.0 * v_ij[..., None] * proj)
            tensor = tensor * W[..., None, :] / d5[..., None, None]
            tensor_i = edges.fold(tensor)
            dq = dq + getattr(self, f"transform_{t}")(
                (mu[f] * tensor_i).sum(1))
        return dq


class NuclearMagneticMomentEmbedding(nn.Module):
    """gamma(Z) * delta(nmm) into the magnetic dipole features
    (``field_schnet.py:164-176``): ``gyromagnetic`` [max_z+1, 1] and
    ``delta`` (1 -> F, no bias)."""

    def __init__(self, n_atom_basis: int, max_z: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gyromagnetic = nn.Embedding(max_z + 1, 1)
        with torch.no_grad():
            self.gyromagnetic.weight.normal_(generator=generator)
        self.delta = Dense(1, n_atom_basis, bias=False, generator=generator)

    def forward(self, Z, nmm):
        return self.gyromagnetic(Z)[:, :, None] * self.delta(nmm[..., None])


class FieldSchNet(nn.Module):
    """FieldSchNet representation -> scalar_representation [A', F]."""

    def __init__(self, n_atom_basis: int = 128, n_interactions: int = 3,
                 n_rbf: int = 20, cutoff: float = 5.0, max_z: int = 100,
                 external_fields: Sequence[str] = (properties.electric_field,),
                 response_properties: Optional[Sequence[str]] = None,
                 nmm_embedding: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fields = list(external_fields)
        for p in response_properties or ():
            for f in properties.required_external_fields.get(p, []):
                if f not in fields:
                    fields.append(f)
        self.fields = tuple(fields)
        F = n_atom_basis
        self.n_atom_basis = F
        self.radial_basis = GaussianRBF(n_rbf, cutoff)
        self.cutoff_fn = CosineCutoff(cutoff)
        self.embedding = nn.Embedding(max_z + 1, F)
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, F ** -0.5, generator=generator)
        self.initial_dipole_update = DipoleUpdate(F, self.fields, generator)
        if nmm_embedding and properties.magnetic_field in self.fields:
            self.nmm_embedding = NuclearMagneticMomentEmbedding(
                F, max_z, generator)
        T = range(n_interactions)
        self.interactions = nn.ModuleList(
            SchNetInteraction(F, n_rbf, F, generator) for _ in T)
        self.field_inter = nn.ModuleList(
            FieldInteraction(F, self.fields, generator=generator) for _ in T)
        self.dipole_inter = nn.ModuleList(
            DipoleInteraction(F, n_rbf, self.fields, generator=generator)
            for _ in T)
        self.dipole_update = nn.ModuleList(
            DipoleUpdate(F, self.fields, generator) for _ in T)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        idx_i = inputs.get(properties.idx_i)
        edges, v_ij, mask = edge_layout(
            inputs, reverse=False,
            dense=(properties.nbh_rij in inputs
                   and (idx_i is None or idx_i.shape[0] <= 1)))
        d_ij = safe_norm(v_ij)
        f_ij = self.radial_basis(d_ij)
        rcut_ij = self.cutoff_fn(d_ij) * mask.to(d_ij.dtype)

        Z = inputs[properties.Z]
        q = self.embedding(Z)
        M = inputs[properties.n_atoms].shape[0]
        idx_m = inputs[properties.idx_m].long().clamp(0, M - 1)
        field_atoms = {}
        for f in self.fields:
            v = inputs.get(f)
            field_atoms[f] = (q.new_zeros((q.shape[0], 3)) if v is None
                              else v.to(q.dtype)[idx_m])
        mu = {f: q.new_zeros((q.shape[0], 3, self.n_atom_basis))
              for f in self.fields}
        mu = self.initial_dipole_update(q, mu, v_ij, rcut_ij, edges)
        nmm = inputs.get(properties.nuclear_magnetic_moments)
        if properties.magnetic_field in self.fields and nmm is not None:
            if not hasattr(self, "nmm_embedding"):
                raise ValueError(
                    "the inputs hold nuclear magnetic moments, but this "
                    "FieldSchNet was made with nmm_embedding=False")
            mu[properties.magnetic_field] = (
                mu[properties.magnetic_field] + self.nmm_embedding(Z, nmm))

        last = len(self.interactions) - 1
        for t, (inter, field, dipole, update) in enumerate(zip(
                self.interactions, self.field_inter, self.dipole_inter,
                self.dipole_update)):
            dq = inter.aggregate(q, f_ij, rcut_ij, edges)
            dq = dq + field(mu, field_atoms)
            dq = dq + dipole(mu, f_ij, d_ij, v_ij, rcut_ij, edges)
            q = q + dq
            if t < last:    # the last block's mu feeds nothing
                mu = update(dq, mu, v_ij, rcut_ij, edges)
        inputs[properties.scalar_representation] = q
        return inputs
