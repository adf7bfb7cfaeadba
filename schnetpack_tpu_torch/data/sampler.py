"""Weighted sampling over imbalanced datasets.

A copy of ``schnetpack_tpu/data/sampler.py`` (parity:
``src/schnetpack/data/sampler.py``: StratifiedSampler over
NumberOfAtomsCriterion / PropertyCriterion with inverse-histogram weights).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .. import properties as structure


class NumberOfAtomsCriterion:
    def __call__(self, dataset) -> np.ndarray:
        return np.array([len(s[structure.Z]) for s in dataset.iter_properties()], float)


class PropertyCriterion:
    def __init__(self, property_name: str):
        self.property_name = property_name

    def __call__(self, dataset) -> np.ndarray:
        return np.array(
            [float(np.asarray(s[self.property_name]).reshape(-1)[0])
             for s in dataset.iter_properties()],
            float,
        )


class StratifiedSampler:
    """Weighted random sampling with inverse bin-frequency weights."""

    def __init__(
        self,
        dataset,
        partition_criterion,
        num_samples: Optional[int] = None,
        num_bins: int = 10,
        replacement: bool = True,
        seed: int = 0,
    ):
        self.num_samples = num_samples or len(dataset)
        self.replacement = replacement
        self._rng = np.random.RandomState(seed)

        values = partition_criterion(dataset)
        edges = np.histogram_bin_edges(values, bins=num_bins)
        bin_idx = np.clip(np.digitize(values, edges[1:-1]), 0, num_bins - 1)
        counts = np.bincount(bin_idx, minlength=num_bins).astype(float)
        inv = np.where(counts > 0, 1.0 / np.maximum(counts, 1.0), 0.0)
        w = inv[bin_idx]
        self.weights = w / w.sum()

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        idx = self._rng.choice(
            len(self.weights), size=self.num_samples,
            replace=self.replacement, p=self.weights,
        )
        return iter(idx.tolist())
