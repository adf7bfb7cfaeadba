"""Harmonic vibrational analysis from the response engine's analytic
Hessian (parity: ``schnetpack_tpu/md/vibrations.py``).

Complements the trajectory spectra (``md/data/spectra.py``) with exact
second derivatives: ``normal_modes`` collates one molecule, takes its
per-molecule Hessian block [Amax, 3, Amax, 3] (``model/base.py``) on the
potential's device, and diagonalises the mass-weighted Hessian on the
host in float64.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import properties as P
from ..transform.atomistic import ATOMIC_MASSES
from ..units import hbar, invcm


def with_hessian(pot):
    """``pot`` itself if a ``Response`` of it computes the Hessian, else a
    potential over the same modules (its weights shared) that adds one."""
    from ..atomistic import Response
    from ..model import NeuralNetworkPotential

    if any(P.hessian in s.response_properties for s in pot.response_specs):
        return pot
    return NeuralNetworkPotential(
        pot.representation,
        list(pot.output_modules) + [Response(response_properties=[P.hessian])],
        input_modules=list(pot.input_modules),
        postprocessors=pot.postprocessors, do_postprocessing=False)


def hessian_inputs(mol: Dict[str, np.ndarray], cutoff: float,
                   device) -> Dict[str, torch.Tensor]:
    """One molecule neighbor-listed at ``cutoff`` and collated as the JAX
    ``normal_modes`` collates it (atoms padded to a multiple of 8 past
    n + 1, pairs to 64, two molecule slots), as tensors on ``device``."""
    from ..data.loader import PaddingSpec, collate, round_up
    from ..train.task import as_tensors
    from ..transform.neighborlist import NeighborListTransform

    n = len(mol[P.Z])
    sample = NeighborListTransform(cutoff)(dict(mol))
    spec = PaddingSpec(n_atoms=round_up(n + 1, 8),
                       n_pairs=round_up(max(len(sample[P.idx_i]), 1), 64),
                       n_molecules=2)
    return as_tensors(collate([sample], spec), device)


def normal_modes(pot, mol: Dict[str, np.ndarray],
                 cutoff: Optional[float] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Harmonic frequencies [cm^-1] and mass-weighted mode vectors of one
    molecule (``mol``: numpy ``_atomic_numbers`` and ``_positions``, and
    a zero cell and pbc) under ``pot``, a ``NeuralNetworkPotential`` with
    its weights loaded, on its device."""
    pot = with_hessian(pot)
    rc = cutoff or getattr(pot.representation, "cutoff", 5.0)
    device = next(pot.parameters()).device
    out = pot(hessian_inputs(mol, rc, device))
    n = len(mol[P.Z])
    Hb = out[P.hessian][0].detach().double().cpu().numpy()
    amax = Hb.shape[0]
    H = Hb.reshape(amax * 3, amax * 3)[:3 * n, :3 * n]
    H = 0.5 * (H + H.T)
    minv = 1.0 / np.sqrt(np.repeat(ATOMIC_MASSES[np.asarray(mol[P.Z])], 3))
    w2, vecs = np.linalg.eigh(H * minv[:, None] * minv[None, :])
    freqs = np.sign(w2) * np.sqrt(np.abs(w2)) * hbar / invcm
    return freqs, vecs
