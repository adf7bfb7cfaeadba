"""Ziegler-Biersack-Littmark screened nuclear repulsion (parity:
``schnetpack_tpu/atomistic/nuclear_repulsion.py``): trainable
softplus-parameterised screening coefficients and exponents, Z_i Z_j / d
times the exponential screening, smoothly cut off, over the flat pair
list."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import properties
from ..nn.cutoff import CosineCutoff
from ..ops.math import safe_norm
from ..ops.scatter import pair_sum, pair_take, segment_sum
from ..units import Bohr
from ..units import ke as KE_ASE

# the universal ZBL parameters (Ziegler, Biersack and Littmark 1985)
_ZBL_COEFFS = np.array([0.18175, 0.50986, 0.28022, 0.02817])
_ZBL_EXPONENTS = np.array([3.19980, 0.94229, 0.40290, 0.20162])
_ZBL_APOW = 0.23
_ZBL_ADIV = 1.0 / (0.8854 * Bohr)  # a = 0.8854 a0 / (Zi^0.23 + Zj^0.23)


def softplus_inverse(x: torch.Tensor) -> torch.Tensor:
    """The inverse of softplus, x + log(-expm1(-x))."""
    return x + torch.log(-torch.expm1(-x))


class ZBLRepulsionEnergy(nn.Module):
    """ZBL repulsion into ``output_key`` [M] (``nuclear_repulsion.py:
    31-81``).  The raw parameters ``coefficients``, ``exponents``,
    ``a_pow`` and ``a_div`` (the flax names) are softplus-inverse values,
    trainable unless ``trainable=False``; the coefficients are normalised
    to sum 1, so that the potential is exactly Z_i Z_j / d at d -> 0."""

    def __init__(self, energy_unit: float = 1.0,
                 output_key: str = "energy_zbl", trainable: bool = True,
                 cutoff_fn: Optional[nn.Module] = None, cutoff: float = 5.0):
        super().__init__()
        self.energy_unit = energy_unit
        self.output_key = output_key
        self.cutoff_fn = cutoff_fn or CosineCutoff(cutoff)
        for name, init in (("coefficients", _ZBL_COEFFS),
                           ("exponents", _ZBL_EXPONENTS),
                           ("a_pow", [_ZBL_APOW]), ("a_div", [_ZBL_ADIV])):
            raw = softplus_inverse(torch.tensor(np.asarray(init, np.float32)))
            if trainable:
                self.register_parameter(name, nn.Parameter(raw))
            else:   # constants: no entry in the state dict, as in flax
                self.register_buffer(name, raw, persistent=False)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        Rij = inputs[properties.Rij]
        Z = inputs[properties.Z].to(Rij.dtype)
        idx_i, idx_j = inputs[properties.idx_i], inputs[properties.idx_j]
        mesh = inputs.get(properties.pair_mesh)
        M = inputs[properties.n_atoms].shape[0]
        coeffs = F.softplus(self.coefficients)
        coeffs = coeffs / coeffs.sum()
        expons = F.softplus(self.exponents)
        apow = F.softplus(self.a_pow)[0]
        adiv = F.softplus(self.a_div)[0]
        d = safe_norm(Rij)
        zi, zj = pair_take(Z, idx_i, mesh), pair_take(Z, idx_j, mesh)
        x = d * (zi ** apow + zj ** apow) * adiv
        phi = (coeffs * torch.exp(-x[:, None] * expons)).sum(-1)
        fcut = self.cutoff_fn(d) * inputs[properties.pair_mask]
        # the factor 1/2: the pair list holds both directions
        e_pair = (0.5 * KE_ASE * self.energy_unit * zi * zj
                  / d.clamp(min=1e-10) * phi * fcut)
        e_atom = pair_sum(e_pair, idx_i, Z.shape[0], mesh)
        inputs[self.output_key] = segment_sum(e_atom,
                                              inputs[properties.idx_m], M)
        return inputs
