"""Output heads: atomwise contributions and tensorial moments (parity:
``schnetpack_tpu/atomistic/atomwise.py``).

Every head is mask-aware: padded atoms contribute exactly zero.  The
per-molecule sums run in float64 (``molecular_sum``): the f32 sum of ~1e4
atomic adds on the GPU would depend on their order at the 1e-6 level.
Module names are the flax ones (``outnet``, ``charge_net``, the gated
MLP at ``GatedEquivariantMLP_0``), so ``convert.py`` maps them by name.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch
from torch import nn

from .. import properties
from ..nn.base import MLP
from ..nn.equivariant import GatedEquivariantMLP
from ..ops.activations import ACTIVATIONS
from ..ops.math import safe_norm

#: the flax name of a head's gated equivariant MLP
GATED = "GatedEquivariantMLP_0"


def _activation(activation: Union[str, Callable]) -> Callable:
    return ACTIVATIONS[activation] if isinstance(activation, str) \
        else activation


def molecular_sum(y: torch.Tensor, inputs: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """Per-molecule sums [M, ...] of atomwise values [A, ...], in float64."""
    M = inputs[properties.n_atoms].shape[0]
    out = y.new_zeros((M,) + y.shape[1:], dtype=torch.float64)
    return out.index_add(0, inputs[properties.idx_m].long(),
                         y.double()).to(y.dtype)


class Atomwise(nn.Module):
    """Per-atom MLP, masked; summed (``"sum"``) or averaged (``"avg"``)
    per molecule into ``output_key`` [M] ([M, n_out] for ``n_out`` > 1),
    or kept per atom (``aggregation_mode=None``); ``per_atom_output_key``
    also keeps the atomwise values (``atomwise.py:23-64``)."""

    def __init__(self, n_in: int = 128, output_key: str = properties.energy,
                 n_out: int = 1, n_layers: int = 2,
                 n_hidden: Optional[Sequence[int]] = None,
                 activation: Union[str, Callable] = "ssp",
                 aggregation_mode: Optional[str] = "sum",
                 per_atom_output_key: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if aggregation_mode not in ("sum", "avg", None):
            raise ValueError(f"aggregation_mode must be 'sum', 'avg' or "
                             f"None, not {aggregation_mode!r}")
        self.output_key = output_key
        self.n_out = n_out
        self.aggregation_mode = aggregation_mode
        self.per_atom_output_key = per_atom_output_key
        self.outnet = MLP(n_in, n_out, hidden=n_hidden, n_layers=n_layers,
                          activation=_activation(activation),
                          generator=generator)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        x = inputs[properties.scalar_representation]
        y = self.outnet(x) * inputs[properties.atom_mask][:, None]
        if self.n_out == 1:
            y = y[:, 0]
        if self.per_atom_output_key is not None:
            inputs[self.per_atom_output_key] = y
        if self.aggregation_mode is None:
            inputs[self.output_key] = y
            return inputs
        agg = molecular_sum(y, inputs)
        if self.aggregation_mode == "avg":
            n = inputs[properties.n_atoms].to(agg.dtype).clamp(min=1.0)
            agg = agg / (n if agg.ndim == 1 else n[:, None])
        inputs[self.output_key] = agg
        return inputs


class DipoleMoment(nn.Module):
    """Dipole from latent partial charges, mu = sum_i q_i r_i (plus atomic
    dipoles from the vector representation), the charges corrected so
    that each molecule's sum is its total charge; ``predict_magnitude``
    returns |mu| (``atomwise.py:67-118``)."""

    def __init__(self, n_in: int = 128,
                 dipole_key: str = properties.dipole_moment,
                 charges_key: str = properties.partial_charges,
                 n_hidden: Optional[Sequence[int]] = None,
                 n_layers: int = 2, activation: Union[str, Callable] = "ssp",
                 predict_magnitude: bool = False,
                 use_vector_representation: bool = False,
                 correct_charges: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dipole_key = dipole_key
        self.charges_key = charges_key
        self.predict_magnitude = predict_magnitude
        self.use_vector_representation = use_vector_representation
        self.correct_charges = correct_charges
        act = _activation(activation)
        if use_vector_representation:
            self.add_module(GATED, GatedEquivariantMLP(
                n_in, 1, n_layers, act, generator=generator))
        else:
            self.charge_net = MLP(n_in, 1, hidden=n_hidden,
                                  n_layers=n_layers, activation=act,
                                  generator=generator)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        s = inputs[properties.scalar_representation]
        R = inputs[properties.R]
        atom_mask = inputs[properties.atom_mask]
        idx_m = inputs[properties.idx_m].long()
        if self.use_vector_representation:
            q, mu = getattr(self, GATED)(
                s, inputs[properties.vector_representation])
            q = q[:, 0]
            atomic_dipoles = mu[..., 0] * atom_mask[:, None]
        else:
            q = self.charge_net(s)[:, 0]
            atomic_dipoles = None
        q = q * atom_mask
        if self.correct_charges:
            M = inputs[properties.n_atoms].shape[0]
            natoms = inputs[properties.n_atoms].to(q.dtype).clamp(min=1.0)
            total = inputs.get(properties.total_charge)
            total = q.new_zeros(M) if total is None else total.to(q.dtype)
            correction = (total - molecular_sum(q, inputs)) / natoms
            q = (q + correction[idx_m]) * atom_mask
        inputs[self.charges_key] = q
        d = q[:, None] * R
        if atomic_dipoles is not None:
            d = d + atomic_dipoles
        y = molecular_sum(d, inputs)
        inputs[self.dipole_key] = (safe_norm(y) if self.predict_magnitude
                                   else y)
        return inputs


class Polarizability(nn.Module):
    """alpha = sum_i [alpha_iso_i I + mu_i r_i^T + r_i mu_i^T] from the
    gated MLP on the scalar and vector representations
    (``atomwise.py:121-153``)."""

    def __init__(self, n_in: int = 128,
                 polar_key: str = properties.polarizability,
                 activation: Union[str, Callable] = "ssp", n_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.polar_key = polar_key
        self.add_module(GATED, GatedEquivariantMLP(
            n_in, 1, n_layers, _activation(activation), generator=generator))

    def forward(self, inputs: Dict[str, torch.Tensor]):
        s = inputs[properties.scalar_representation]
        R = inputs[properties.R]
        atom_mask = inputs[properties.atom_mask]
        alpha_iso, mu = getattr(self, GATED)(
            s, inputs[properties.vector_representation])
        alpha_iso = alpha_iso[:, 0] * atom_mask
        mu = mu[..., 0] * atom_mask[:, None]
        eye = torch.eye(3, dtype=s.dtype, device=s.device)
        aniso = mu[:, :, None] * R[:, None, :]
        per_atom = (alpha_iso[:, None, None] * eye + aniso
                    + aniso.transpose(1, 2))
        inputs[self.polar_key] = molecular_sum(per_atom, inputs)
        return inputs


class Aggregation(nn.Module):
    """The sum of several predicted contributions into one key
    (``atomwise.py:156-170``)."""

    def __init__(self, keys: Sequence[str],
                 output_key: str = properties.energy):
        super().__init__()
        self.keys = list(keys)
        self.output_key = output_key

    def forward(self, inputs: Dict[str, torch.Tensor]):
        total = inputs[self.keys[0]]
        for k in self.keys[1:]:
            total = total + inputs[k]
        inputs[self.output_key] = total
        return inputs
