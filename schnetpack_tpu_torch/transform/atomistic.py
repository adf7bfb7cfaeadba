"""Atomistic pre- and post-processing transforms and the mass table (port
of ``schnetpack_tpu/transform/atomistic.py``).

``SubtractCenterOfMass``, ``SubtractCenterOfGeometry``, ``RemoveOffsets``
and ``ScaleProperty`` act on one sample's numpy dict in the data
pipeline; ``AddOffsets`` is a postprocessor over the padded batch's
tensors.  ``ATOMIC_MASSES`` holds the standard atomic masses in Dalton,
indexed by atomic number.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import properties
from .base import Transform

ATOMIC_MASSES = np.array([
    0.0, 1.008, 4.0026, 6.94, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998,
    20.180, 22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948,
    39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845, 58.933,
    58.693, 63.546, 65.38, 69.723, 72.630, 74.922, 78.971, 79.904, 83.798,
    85.468, 87.62, 88.906, 91.224, 92.906, 95.95, 97.0, 101.07, 102.91,
    106.42, 107.87, 112.41, 114.82, 118.71, 121.76, 127.60, 126.90, 131.29,
    132.91, 137.33, 138.91, 140.12, 140.91, 144.24, 145.0, 150.36, 151.96,
    157.25, 158.93, 162.50, 164.93, 167.26, 168.93, 173.05, 174.97, 178.49,
    180.95, 183.84, 186.21, 190.23, 192.22, 195.08, 196.97, 200.59, 204.38,
    207.2, 208.98, 209.0, 210.0, 222.0, 223.0, 226.0, 227.0, 232.04, 231.04,
    238.03, 237.0, 244.0, 243.0, 247.0, 247.0, 251.0, 252.0, 257.0, 258.0,
    259.0, 262.0,
])


class SubtractCenterOfMass(Transform):
    is_preprocessor = True

    def __call__(self, inputs):
        m = ATOMIC_MASSES[np.asarray(inputs[properties.Z])]
        R = np.asarray(inputs[properties.R], dtype=np.float64)
        com = (m[:, None] * R).sum(0) / m.sum()
        inputs[properties.R] = R - com
        return inputs


class SubtractCenterOfGeometry(Transform):
    is_preprocessor = True

    def __call__(self, inputs):
        R = np.asarray(inputs[properties.R], dtype=np.float64)
        inputs[properties.R] = R - R.mean(0)
        return inputs


class RemoveOffsets(Transform):
    """Subtract single-atom reference energies and/or the training set's
    mean from a target property (``atomistic.py:56-95``)."""

    is_preprocessor = True

    def __init__(self, property: str, remove_mean: bool = False,
                 remove_atomrefs: bool = False, is_extensive: bool = True,
                 atomrefs: Optional[np.ndarray] = None,
                 property_mean: Optional[float] = None):
        self._property = property
        self.remove_mean = remove_mean
        self.remove_atomrefs = remove_atomrefs
        self.is_extensive = is_extensive
        self.atomrefs = (np.asarray(atomrefs, dtype=np.float64)
                         if atomrefs is not None else None)
        self.mean = property_mean

    def datamodule(self, dm) -> None:
        if self.remove_atomrefs and self.atomrefs is None:
            self.atomrefs = np.asarray(
                dm.train_dataset.atomrefs[self._property], dtype=np.float64)
        if self.remove_mean and self.mean is None:
            stats = dm.get_stats(self._property, self.is_extensive,
                                 self.remove_atomrefs)
            self.mean = float(stats[0])

    def __call__(self, inputs):
        v = np.asarray(inputs[self._property], dtype=np.float64)
        Z = np.asarray(inputs[properties.Z])
        if self.remove_atomrefs:
            v = v - self.atomrefs[Z].sum()
        if self.remove_mean:
            v = v - self.mean * (len(Z) if self.is_extensive else 1.0)
        inputs[self._property] = v
        return inputs


class AddOffsets(Transform):
    """Inverse of ``RemoveOffsets`` as a postprocessor over the padded
    batch's tensors (``atomistic.py:98-152``)."""

    is_preprocessor = False
    is_postprocessor = True

    def __init__(self, property: str, add_mean: bool = False,
                 add_atomrefs: bool = False, is_extensive: bool = True,
                 atomrefs: Optional[np.ndarray] = None,
                 property_mean: Optional[float] = None):
        self._property = property
        self.add_mean = add_mean
        self.add_atomrefs = add_atomrefs
        self.is_extensive = is_extensive
        self.atomrefs = (np.asarray(atomrefs, dtype=np.float64)
                         if atomrefs is not None else None)
        self.mean = property_mean

    def datamodule(self, dm) -> None:
        if self.add_atomrefs and self.atomrefs is None:
            self.atomrefs = np.asarray(
                dm.train_dataset.atomrefs[self._property], dtype=np.float64)
        if self.add_mean and self.mean is None:
            stats = dm.get_stats(self._property, self.is_extensive,
                                 self.add_atomrefs)
            self.mean = float(stats[0])

    def __call__(self, inputs):
        from ..ops.scatter import segment_sum

        v = inputs[self._property]
        if self.add_atomrefs:
            M = inputs[properties.n_atoms].shape[0]
            refs = torch.as_tensor(self.atomrefs, dtype=v.dtype,
                                   device=v.device)
            e0 = (refs[inputs[properties.Z].long()]
                  * inputs[properties.atom_mask].to(v.dtype))
            v = v + segment_sum(e0, inputs[properties.idx_m], M)
        if self.add_mean:
            n = (inputs[properties.n_atoms].to(v.dtype)
                 if self.is_extensive else 1.0)
            v = v + self.mean * n * inputs.get(properties.mol_mask, 1.0)
        inputs[self._property] = v
        return inputs


class ScaleProperty(Transform):
    """Scale a property by a factor (``atomistic.py:155-167``)."""

    is_preprocessor = True

    def __init__(self, input_key: str, target_key: Optional[str] = None,
                 scale: float = 1.0):
        self.input_key = input_key
        self.target_key = target_key or input_key
        self.scale = scale

    def __call__(self, inputs):
        inputs[self.target_key] = np.asarray(inputs[self.input_key]) * self.scale
        return inputs
