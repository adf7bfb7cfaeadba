"""Dataset statistics: streaming mean/std and atomref estimation.

A copy of ``schnetpack_tpu/data/stats.py`` (parity:
``src/schnetpack/data/stats.py``: calculate_stats with per-atom
normalization and atomref removal via Welford's algorithm;
estimate_atomrefs least-squares on composition counts).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .. import properties as structure


def calculate_stats(
    dataset,
    divide_by_atoms: Dict[str, bool],
    atomref: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, Tuple[float, float]]:
    """Streaming (Welford) mean/std per property over the dataset."""
    atomref = atomref or {}
    count = {k: 0 for k in divide_by_atoms}
    mean = {k: 0.0 for k in divide_by_atoms}
    m2 = {k: 0.0 for k in divide_by_atoms}
    for sample in dataset.iter_properties():
        Z = np.asarray(sample[structure.Z])
        n = len(Z)
        for k in divide_by_atoms:
            v = float(np.asarray(sample[k]).reshape(-1)[0])
            if k in atomref and atomref[k] is not None:
                v = v - float(np.asarray(atomref[k])[Z].sum())
            if divide_by_atoms[k]:
                v = v / n
            count[k] += 1
            delta = v - mean[k]
            mean[k] += delta / count[k]
            m2[k] += delta * (v - mean[k])
    return {
        k: (mean[k], float(np.sqrt(m2[k] / max(count[k], 1))))
        for k in divide_by_atoms
    }


def estimate_atomrefs(
    dataset, property_name: str, z_max: int = 100
) -> np.ndarray:
    """Least-squares single-atom reference energies from composition counts:
    w = (X^T X)^-1 X^T y (parity: stats.py:83-143)."""
    X_rows = []
    y = []
    for sample in dataset.iter_properties():
        Z = np.asarray(sample[structure.Z])
        row = np.bincount(Z, minlength=z_max + 1)
        X_rows.append(row)
        y.append(float(np.asarray(sample[property_name]).reshape(-1)[0]))
    X = np.asarray(X_rows, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    w, *_ = np.linalg.lstsq(X, y, rcond=None)
    return w
