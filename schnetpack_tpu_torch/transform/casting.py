"""dtype casting transforms (port of
``schnetpack_tpu/transform/casting.py``): numpy arrays in a sample, tensors
in a model's outputs."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import Transform


class CastMap(Transform):
    """Casts every entry whose dtype name (``float64``, ``int64``, ...) is a
    key of ``type_map`` to the mapped dtype."""

    is_preprocessor = True
    is_postprocessor = True

    def __init__(self, type_map: Dict[str, str]):
        self.type_map = type_map

    def __call__(self, inputs):
        for k, v in list(inputs.items()):
            if isinstance(v, torch.Tensor):
                name = str(v.dtype).replace("torch.", "")
                if name in self.type_map:
                    inputs[k] = v.to(getattr(torch, self.type_map[name]))
                continue
            v = np.asarray(v)
            if str(v.dtype) in self.type_map:
                inputs[k] = v.astype(self.type_map[str(v.dtype)])
        return inputs


class CastTo32(CastMap):
    def __init__(self):
        super().__init__({"float64": "float32", "int64": "int32"})


class CastTo64(CastMap):
    def __init__(self):
        super().__init__({"float32": "float64"})
