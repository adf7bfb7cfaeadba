"""Transform base classes (port of ``schnetpack_tpu/transform/base.py``).

Transforms are plain Python objects: preprocessors act on one sample's
dict of numpy arrays in the data pipeline, postprocessors on the model's
output dict of tensors.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class Transform:
    is_preprocessor: bool = False
    is_postprocessor: bool = False

    def datamodule(self, value) -> None:
        """Hook for pulling dataset statistics; called once during setup."""

    def teardown(self) -> None:
        pass

    def __call__(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class ComposedTransform(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)
        self.is_preprocessor = all(t.is_preprocessor for t in self.transforms)
        self.is_postprocessor = all(t.is_postprocessor
                                    for t in self.transforms)

    def datamodule(self, value) -> None:
        for t in self.transforms:
            t.datamodule(value)

    def __call__(self, inputs):
        for t in self.transforms:
            inputs = t(inputs)
        return inputs
