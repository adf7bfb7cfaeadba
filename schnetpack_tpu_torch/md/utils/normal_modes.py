"""Ring-polymer normal modes (parity: ``schnetpack_tpu/md/utils/
normal_modes.py``).

The bead <-> normal-mode transform is an orthogonal [P, P] matrix applied
along the replica axis: one small matrix product, as in the JAX package,
which computes it outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def normal_mode_matrix(n_beads: int) -> np.ndarray:
    """Orthogonal C with (C x)_k = normal mode k of bead vector x."""
    P = n_beads
    C = np.zeros((P, P))
    j = np.arange(P)
    C[0, :] = np.sqrt(1.0 / P)
    for k in range(1, P // 2 + 1):
        if 2 * k == P:
            C[k, :] = np.sqrt(1.0 / P) * (-1.0) ** j
        else:
            C[k, :] = np.sqrt(2.0 / P) * np.cos(2 * np.pi * k * j / P)
    for k in range(P // 2 + 1, P):
        C[k, :] = np.sqrt(2.0 / P) * np.sin(2 * np.pi * (P - k) * j / P)
    return C


def normal_mode_frequencies(n_beads: int, omega_P: float) -> np.ndarray:
    """omega_k = 2 omega_P sin(k pi / P) in ``normal_mode_matrix``'s row
    order."""
    P = n_beads
    k = np.arange(P)
    mode = np.where(k <= P // 2, k, P - k)
    return 2.0 * omega_P * np.sin(mode * np.pi / P)


class NormalModeTransformer:
    """``beads2normal`` and ``normal2beads`` on [P, ...] tensors; the
    matrix is cast to each input's dtype and device once."""

    def __init__(self, n_beads: int):
        self.n_beads = n_beads
        self.c = normal_mode_matrix(n_beads)
        self._cast: Dict[Tuple[torch.dtype, torch.device], torch.Tensor] = {}

    def _matrix(self, x: torch.Tensor) -> torch.Tensor:
        key = (x.dtype, x.device)
        if key not in self._cast:
            self._cast[key] = torch.as_tensor(self.c, dtype=x.dtype,
                                              device=x.device)
        return self._cast[key]

    def beads2normal(self, x: torch.Tensor) -> torch.Tensor:
        """[P, A, 3] -> [P, A, 3] in normal-mode space."""
        return torch.einsum("kp,p...->k...", self._matrix(x), x)

    def normal2beads(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("pk,k...->p...", self._matrix(x).T, x)
