"""Response-property transforms (a copy of
``schnetpack_tpu/transform/response.py``): ``SplitShielding`` writes one
key per element, ``{shielding_key}_{z}``, holding the shielding tensors of
that element's atoms and zeros elsewhere, so that each element trains on
its own loss."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .. import properties
from .base import Transform


class SplitShielding(Transform):
    is_preprocessor = True

    def __init__(self, shielding_key: str = properties.shielding,
                 atomic_numbers: Sequence[int] = (1, 6, 7, 8)):
        self.shielding_key = shielding_key
        self.atomic_numbers = list(atomic_numbers)

    def __call__(self, inputs: Dict[str, np.ndarray]
                 ) -> Dict[str, np.ndarray]:
        sigma = inputs[self.shielding_key]
        Z = inputs[properties.Z]
        for z in self.atomic_numbers:
            mask = Z == z
            mask = mask.reshape(mask.shape + (1,) * (sigma.ndim - 1))
            inputs[f"{self.shielding_key}_{z}"] = sigma * mask
        return inputs
