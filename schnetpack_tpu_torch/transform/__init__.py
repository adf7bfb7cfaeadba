"""Host-side (numpy) transforms of the data pipeline: neighbor lists,
atomistic offsets and casting (port of ``schnetpack_tpu/transform``)."""
from .atomistic import (
    AddOffsets,
    RemoveOffsets,
    ScaleProperty,
    SubtractCenterOfGeometry,
    SubtractCenterOfMass,
)
from .base import ComposedTransform, Transform
from .casting import CastMap, CastTo32, CastTo64
from .response import SplitShielding
from .neighborlist import (
    ASENeighborList,
    CachedNeighborList,
    CollectAtomTriples,
    CountNeighbors,
    FilterNeighbors,
    MatScipyNeighborList,
    NeighborListTransform,
    SkinNeighborList,
    TorchNeighborList,
    VesinNeighborList,
    WrapPositions,
)

__all__ = [
    "AddOffsets", "RemoveOffsets", "ScaleProperty",
    "SubtractCenterOfGeometry", "SubtractCenterOfMass",
    "CastMap", "CastTo32", "CastTo64", "SplitShielding",
    "ComposedTransform", "Transform",
    "ASENeighborList", "CachedNeighborList", "CollectAtomTriples",
    "CountNeighbors", "FilterNeighbors", "MatScipyNeighborList",
    "NeighborListTransform", "SkinNeighborList", "TorchNeighborList",
    "VesinNeighborList", "WrapPositions",
]
