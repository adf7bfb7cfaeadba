"""Response specs and the input modules that make response properties
differentiable (parity: ``schnetpack_tpu/atomistic/response.py``).

``Forces`` and ``Response`` are declarative specs:
``NeuralNetworkPotential`` builds one energy closure and differentiates
it with ``torch.autograd.grad`` (``model/base.py``).  ``Strain`` makes
stress differentiable: it maps positions, cells and periodic offsets by
x -> x + x @ eps with a per-molecule strain eps [M, 3, 3], so that stress
= (dE/deps) / V.  ``StaticExternalFields`` puts zero external fields into
the inputs, which the engine replaces by differentiable leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from .. import properties
from ..ops.scatter import take


def strained(x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """x + x @ eps for row vectors x [..., 3] and eps [..., 3, 3] that
    broadcast, as elementwise products (a batched matmul of 1 x 3 rows
    runs one tiny product per row on the GPU)."""
    return x + (x[..., :, None] * eps).sum(-2)


class Strain(nn.Module):
    """x -> x + x @ eps on ``R``, ``cell``, ``offsets``, ``offsets_lr`` and
    the dense (and 27-cell) layout's ``nbh_offsets``, where the inputs
    hold a strain (``response.py:28-60``); the per-atom and per-pair
    strains are gathered with ``take``, whose VJP is ``index_add_`` (the
    advanced-index gather's is a sort).  The column layout's offsets
    (``cell_coff``, ``cell_coff_fm``) are not strained, as in the JAX
    package: the engine refuses stress there (``ColumnStressError``)."""

    def forward(self, inputs: Dict[str, torch.Tensor]):
        if properties.strain not in inputs:
            return inputs
        eps = inputs[properties.strain]                     # [M, 3, 3]
        idx_m = inputs[properties.idx_m]
        eps_atom = take(eps, idx_m)                         # [A, 3, 3]
        inputs[properties.R] = strained(inputs[properties.R], eps_atom)
        inputs[properties.cell] = strained(inputs[properties.cell],
                                           eps[:, None])
        for off_key, i_key in ((properties.offsets, properties.idx_i),
                               (properties.offsets_lr, properties.idx_i_lr)):
            if off_key in inputs:
                eps_pair = take(eps, take(idx_m, inputs[i_key]))
                inputs[off_key] = strained(inputs[off_key], eps_pair)
        if properties.nbh_offsets in inputs:
            inputs[properties.nbh_offsets] = strained(
                inputs[properties.nbh_offsets], eps_atom[:, None])
        return inputs


class StaticExternalFields(nn.Module):
    """Zero external fields [M, 3] (and zero nuclear magnetic moments [A,
    3] with a magnetic field) for the fields that ``required_fields``
    names or that ``response_properties`` need, where the inputs lack
    them (``response.py:63-91``)."""

    def __init__(self, required_fields: Sequence[str] = (),
                 response_properties: Optional[Sequence[str]] = None):
        super().__init__()
        fields = list(required_fields)
        for p in response_properties or ():
            for f in properties.required_external_fields.get(p, []):
                if f not in fields:
                    fields.append(f)
        self.fields = fields

    def forward(self, inputs: Dict[str, torch.Tensor]):
        R = inputs[properties.R]
        M = inputs[properties.n_atoms].shape[0]
        for field in self.fields:
            if field not in inputs:
                inputs[field] = R.new_zeros((M, 3))
        if (properties.magnetic_field in self.fields
                and properties.nuclear_magnetic_moments not in inputs):
            inputs[properties.nuclear_magnetic_moments] = R.new_zeros(
                (inputs[properties.Z].shape[0], 3))
        return inputs


@dataclasses.dataclass
class Forces:
    """Spec: forces = -dE/dR and, with ``calc_stress``, the stress
    (``response.py:94-112``)."""

    calc_forces: bool = True
    calc_stress: bool = False
    energy_key: str = properties.energy
    force_key: str = properties.forces
    stress_key: str = properties.stress

    @property
    def response_properties(self) -> List[str]:
        out = []
        if self.calc_forces:
            out.append(properties.forces)
        if self.calc_stress:
            out.append(properties.stress)
        return out


@dataclasses.dataclass
class Response:
    """Spec of the general response engine (``response.py:115-140``):
    forces, stress, hessian, dipole_moment (-dE/dF), polarizability
    (-d2E/dF2), dipole_derivatives, partial_charges,
    polarizability_derivatives, shielding (d2E/dB dI) and
    nuclear_spin_coupling (d2E/dI2).  The field responses need a
    representation that reads the external fields (FieldSchNet)."""

    energy_key: str = properties.energy
    response_properties: Sequence[str] = (properties.forces,)

    def __post_init__(self):
        self.response_properties = list(self.response_properties)

    @property
    def required_fields(self) -> List[str]:
        fields = []
        for p in self.response_properties:
            for f in properties.required_external_fields.get(p, []):
                if f not in fields:
                    fields.append(f)
        return fields


def is_response_module(obj) -> bool:
    return isinstance(obj, (Forces, Response))


#: the responses that are second derivatives of the energy
SECOND_ORDER = frozenset({
    properties.hessian, properties.polarizability,
    properties.dipole_derivatives, properties.partial_charges,
    properties.polarizability_derivatives, properties.shielding,
    properties.nuclear_spin_coupling})


def required_derivatives(specs: Sequence) -> Dict[str, bool]:
    """Which leaves the energy closure must expose as differentiable
    (``response.py:147-165``)."""
    props = set()
    for s in specs:
        props.update(s.response_properties)
    return {
        "positions": bool(props & {
            properties.forces, properties.hessian,
            properties.dipole_derivatives, properties.partial_charges,
            properties.polarizability_derivatives}),
        "strain": properties.stress in props,
        "electric_field": bool(props & {
            properties.dipole_moment, properties.polarizability,
            properties.dipole_derivatives, properties.partial_charges,
            properties.polarizability_derivatives}),
        "magnetic_field": bool(props & {properties.shielding}),
        "nuclear_magnetic_moments": bool(props & {
            properties.shielding, properties.nuclear_spin_coupling}),
    }
