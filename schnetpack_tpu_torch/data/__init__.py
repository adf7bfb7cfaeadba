from .atoms import ASEAtomsData, create_dataset, load_dataset
from .datamodule import AtomsDataModule
from .loader import (
    AtomsLoader,
    PaddingSpec,
    collate,
    padding_for,
    static_padding_for_dataset,
)
from .sampler import NumberOfAtomsCriterion, PropertyCriterion, StratifiedSampler
from .splitting import GroupSplit, RandomSplit, SubsamplePartitions, random_split
from .stats import calculate_stats, estimate_atomrefs

__all__ = [
    "ASEAtomsData", "create_dataset", "load_dataset", "AtomsDataModule",
    "AtomsLoader", "PaddingSpec", "collate", "padding_for",
    "static_padding_for_dataset",
    "NumberOfAtomsCriterion", "PropertyCriterion", "StratifiedSampler",
    "GroupSplit", "RandomSplit", "SubsamplePartitions", "random_split",
    "calculate_stats", "estimate_atomrefs",
]
