"""Response spec (parity: ``schnetpack_tpu/atomistic/response.py:94-112``).

``Forces`` is a declarative spec: ``NeuralNetworkPotential`` differentiates
the energy with ``torch.autograd.grad`` when it is present.
"""
from __future__ import annotations

import dataclasses

from .. import properties


@dataclasses.dataclass
class Forces:
    """Spec: forces = -dE/dR from the energy head (stress not ported)."""

    energy_key: str = properties.energy
    force_key: str = properties.forces
