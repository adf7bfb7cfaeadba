"""Train/val/test splitting strategies.

A copy of ``schnetpack_tpu/data/splitting.py`` (parity:
``src/schnetpack/data/splitting.py``: random_split / RandomSplit /
SubsamplePartitions / GroupSplit)).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def absolute_split_sizes(dsize: int, split_sizes: Sequence) -> List[int]:
    """Resolve None / fractional / absolute sizes (parity: splitting.py:9-63)."""
    none_idx = None
    sizes: List[Optional[int]] = []
    psum = 0
    for i, s in enumerate(split_sizes):
        if s is None or (isinstance(s, float) and s < 0):
            if none_idx is not None:
                raise ValueError("Only one split size may be undefined")
            none_idx = i
            sizes.append(None)
        else:
            s_abs = int(round(s * dsize)) if isinstance(s, float) and 0.0 < s <= 1.0 else int(s)
            sizes.append(s_abs)
            psum += s_abs
    if psum > dsize:
        raise ValueError(f"Split sizes {split_sizes} exceed dataset size {dsize}")
    if none_idx is not None:
        sizes[none_idx] = dsize - psum
    return [int(s) for s in sizes]


def random_split(dsize: int, *split_sizes, seed: Optional[int] = None) -> List[np.ndarray]:
    sizes = absolute_split_sizes(dsize, split_sizes)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(dsize)
    out = []
    off = 0
    for s in sizes:
        out.append(perm[off: off + s])
        off += s
    return out


class SplittingStrategy:
    def split(self, dataset, *split_sizes) -> List[np.ndarray]:
        raise NotImplementedError


class RandomSplit(SplittingStrategy):
    def __init__(self, seed: Optional[int] = None):
        self.seed = seed

    def split(self, dataset, *split_sizes):
        return random_split(len(dataset), *split_sizes, seed=self.seed)


class SubsamplePartitions(SplittingStrategy):
    """Draw splits from predefined partitions recorded in the dataset
    metadata (parity: splitting.py:99-170)."""

    def __init__(self, split_partition_sources: Sequence[str], split_id: int = 0,
                 base_splits: Optional[Dict[str, Sequence[int]]] = None, seed: Optional[int] = None):
        self.sources = list(split_partition_sources)
        self.split_id = split_id
        self.base_splits = base_splits
        self.seed = seed

    def split(self, dataset, *split_sizes):
        md = dataset.metadata
        partitions = self.base_splits or md.get("splits", {})
        rng = np.random.RandomState(self.seed)
        out = []
        for src, size in zip(self.sources, split_sizes):
            part = partitions.get(src)
            if part is None:
                raise KeyError(f"partition {src!r} not in dataset metadata")
            part = np.asarray(part)
            if part.ndim > 1:
                part = part[self.split_id]
            sel = rng.permutation(len(part))[: int(size) if size else len(part)]
            out.append(part[sel])
        return out


class GroupSplit(SplittingStrategy):
    """Group-disjoint splitting, e.g. by conformer group
    (parity: splitting.py:172-244)."""

    def __init__(self, splitting_key: str, seed: Optional[int] = None):
        self.splitting_key = splitting_key
        self.seed = seed

    def split(self, dataset, *split_sizes):
        groups = []
        for s in dataset.iter_properties():
            groups.append(int(np.asarray(s[self.splitting_key]).reshape(-1)[0]))
        groups = np.asarray(groups)
        unique = np.unique(groups)
        sizes = absolute_split_sizes(len(unique), split_sizes)
        rng = np.random.RandomState(self.seed)
        perm = rng.permutation(len(unique))
        out = []
        off = 0
        for s in sizes:
            sel_groups = set(unique[perm[off: off + s]].tolist())
            out.append(np.nonzero([g in sel_groups for g in groups])[0])
            off += s
        return out
