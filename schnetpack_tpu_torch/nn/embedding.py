"""Nuclear and electronic embeddings (parity:
``schnetpack_tpu/nn/embedding.py``).

``electron_config_matrix`` is the port's own copy of the JAX package's
table (ground-state configurations by Aufbau filling with the standard
d/s exceptions, Z = 0..118), made with numpy alone.  ``NuclearEmbedding``
adds a learnable per-element vector to a linear map of that table;
``ElectronicEmbedding`` spreads a molecule's total charge or spin over
its atoms by nonnegative attention weights and maps each share through a
``ResidualMLP``.  Its per-molecule sum is ``index_add_``: the JAX
package's ``segment_sum`` (``ops/scatter.py:50-65``) also zeroes
non-finite rows at 128 segments or fewer and drops out-of-range ids, which
``index_add_`` does not, so the two agree on finite weights and in-range
molecule ids.  Zero-initialised parameters (the element table, the keys
and values, the ``ResidualMLP``'s last layer) start as flax starts them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from .. import properties
from ..ops.activations import shifted_softplus
from .base import Dense, ResidualMLP

# Madelung (n+l, n) ordering of subshells up to 7p — enough for Z <= 118.
_SUBSHELLS = [
    (1, "s"), (2, "s"), (2, "p"), (3, "s"), (3, "p"), (4, "s"), (3, "d"),
    (4, "p"), (5, "s"), (4, "d"), (5, "p"), (6, "s"), (4, "f"), (5, "d"),
    (6, "p"), (7, "s"), (5, "f"), (6, "d"), (7, "p"),
]
_L_CAP = {"s": 2, "p": 6, "d": 10, "f": 14}

# standard deviations from Aufbau: Z -> {(n, l): occupancy delta}
_AUFBAU_EXCEPTIONS: Dict[int, Dict[tuple, int]] = {
    24: {(4, "s"): -1, (3, "d"): +1},   # Cr
    29: {(4, "s"): -1, (3, "d"): +1},   # Cu
    41: {(5, "s"): -1, (4, "d"): +1},   # Nb
    42: {(5, "s"): -1, (4, "d"): +1},   # Mo
    44: {(5, "s"): -1, (4, "d"): +1},   # Ru
    45: {(5, "s"): -1, (4, "d"): +1},   # Rh
    46: {(5, "s"): -2, (4, "d"): +2},   # Pd
    47: {(5, "s"): -1, (4, "d"): +1},   # Ag
    57: {(4, "f"): -1, (5, "d"): +1},   # La
    58: {(4, "f"): -1, (5, "d"): +1},   # Ce
    64: {(4, "f"): -1, (5, "d"): +1},   # Gd
    78: {(6, "s"): -1, (5, "d"): +1},   # Pt
    79: {(6, "s"): -1, (5, "d"): +1},   # Au
    89: {(5, "f"): -1, (6, "d"): +1},   # Ac
    90: {(5, "f"): -2, (6, "d"): +2},   # Th
    91: {(5, "f"): -1, (6, "d"): +1},   # Pa
    92: {(5, "f"): -1, (6, "d"): +1},   # U
    93: {(5, "f"): -1, (6, "d"): +1},   # Np
    96: {(5, "f"): -1, (6, "d"): +1},   # Cm
}


def electron_config_matrix(max_z: int = 100) -> np.ndarray:
    """[max_z+1, 24] matrix: Z, subshell occupancies (19), valence s/p/d/f.

    Row 0 (padding atoms, Z=0) is all zeros.  Columns are normalized to
    [0, 1] by their maxima so the linear map sees O(1) features.
    """
    n_sub = len(_SUBSHELLS)
    mat = np.zeros((max_z + 1, 1 + n_sub + 4), dtype=np.float64)
    for z in range(1, max_z + 1):
        occ = {}
        remaining = z
        for (n, l) in _SUBSHELLS:
            fill = min(remaining, _L_CAP[l])
            occ[(n, l)] = fill
            remaining -= fill
            if remaining == 0:
                break
        for key, delta in _AUFBAU_EXCEPTIONS.get(z, {}).items():
            occ[key] = occ.get(key, 0) + delta
        mat[z, 0] = z
        for i, (n, l) in enumerate(_SUBSHELLS):
            mat[z, 1 + i] = occ.get((n, l), 0)
        # valence = electrons in the highest occupied principal shell (s, p)
        # plus the open d/f subshells below it
        n_max = max((n for (n, l), o in occ.items() if o > 0), default=0)
        vs = occ.get((n_max, "s"), 0)
        vp = occ.get((n_max, "p"), 0)
        vd = occ.get((n_max - 1, "d"), 0)
        vd = vd if vd < 10 else 0
        vf = occ.get((n_max - 2, "f"), 0)
        vf = vf if vf < 14 else 0
        mat[z, 1 + n_sub: 1 + n_sub + 4] = [vs, vp, vd, vf]
    col_max = mat.max(axis=0)
    col_max[col_max == 0] = 1.0
    return (mat / col_max).astype(np.float32)


class NuclearEmbedding(nn.Module):
    """Element embedding: a learnable per-Z vector (``element_embedding``)
    plus a linear map (``config_linear``, no bias) of the frozen
    electron-configuration descriptor (``nn/embedding.py:89-107``)."""

    def __init__(self, n_features: int, max_z: int = 100,
                 zero_init: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = (max_z + 1, n_features)
        self.element_embedding = nn.Parameter(
            torch.zeros(shape) if zero_init
            else torch.randn(shape, generator=generator))
        self.register_buffer("config", torch.as_tensor(
            electron_config_matrix(max_z)), persistent=False)
        self.config_linear = Dense(self.config.shape[1], n_features,
                                   bias=False, generator=generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        table = self.element_embedding + self.config_linear(self.config)
        return table[z]


class ElectronicEmbedding(nn.Module):
    """Attention-style conditioning on a per-molecule total charge or spin
    (``nn/embedding.py:110-155``): each atom receives a share of the
    attribute proportional to softplus(q . k / sqrt(F)), positive and
    negative attributes with separate keys and values (``is_charged``)."""

    def __init__(self, n_features: int, num_residual: int = 1,
                 is_charged: bool = True,
                 activation: Callable = shifted_softplus,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        F = n_features
        self.is_charged = is_charged
        self.query = Dense(F, F, bias=False, generator=generator)
        self.k_plus = nn.Parameter(torch.zeros(F))
        self.v_plus = nn.Parameter(torch.zeros(F))
        if is_charged:
            self.k_minus = nn.Parameter(torch.zeros(F))
            self.v_minus = nn.Parameter(torch.zeros(F))
        self.resmlp = ResidualMLP(F, F, n_residual=num_residual,
                                  activation=activation, last_zero_init=True,
                                  generator=generator)

    def forward(self, x: torch.Tensor, attribute: torch.Tensor,
                idx_m: torch.Tensor, num_mol: int) -> torch.Tensor:
        F = x.shape[-1]
        q = self.query(x)
        k_neg, v_neg = ((self.k_minus, self.v_minus) if self.is_charged
                        else (self.k_plus, self.v_plus))
        attr_atom = attribute[idx_m]
        pos = (attr_atom >= 0)[:, None]
        k = torch.where(pos, self.k_plus, k_neg)
        v = torch.where(pos, self.v_plus, v_neg)
        weights = TF.softplus((q * k).sum(-1) / F ** 0.5)
        denom = weights.new_zeros(num_mol).index_add(
            0, idx_m.long(), weights) + 1e-8
        share = weights / denom[idx_m] * attr_atom.abs()
        return self.resmlp(share[:, None] * v)


def add_embeddings(rep: nn.Module, n_features: int, max_z: int,
                   nuclear_embedding: bool = False,
                   electronic_embeddings: tuple = (),
                   generator: Optional[torch.Generator] = None) -> None:
    """Give a representation its atom embedding, ``rep.embedding``: a
    ``NuclearEmbedding`` or a plain table (flax's ``nn.Embed``, normal with
    std F^-1/2 here), and per entry of ``electronic_embeddings`` ("charge",
    "spin") an ``ElectronicEmbedding`` as ``rep.{kind}_embedding``, the
    flax module names (``schnet.py:195-208``, ``painn.py:460-478``)."""
    if nuclear_embedding:
        rep.embedding = NuclearEmbedding(n_features, max_z,
                                         generator=generator)
    else:
        rep.embedding = nn.Embedding(max_z + 1, n_features)
        with torch.no_grad():
            rep.embedding.weight.normal_(0.0, n_features ** -0.5,
                                         generator=generator)
    for kind in electronic_embeddings:
        if kind not in ("charge", "spin"):
            raise ValueError(f"unknown electronic embedding {kind!r}")
        setattr(rep, f"{kind}_embedding", ElectronicEmbedding(
            n_features, is_charged=kind == "charge", generator=generator))


def embed_atoms(rep: nn.Module, inputs: Dict[str, torch.Tensor]):
    """The atom features [A', F] of ``add_embeddings``' modules: the
    embedding of Z, then the total charge's and the spin's terms added in
    turn, each read from the inputs (zeros where missing)."""
    x = rep.embedding(inputs[properties.Z])
    for kind, key in (("charge", properties.total_charge),
                      ("spin", properties.spin_multiplicity)):
        emb = getattr(rep, f"{kind}_embedding", None)
        if emb is not None:
            M = inputs[properties.n_atoms].shape[0]
            a = inputs.get(key)
            a = x.new_zeros(M) if a is None else a.to(x.dtype)
            x = x + emb(x, a, inputs[properties.idx_m], M)
    return x
