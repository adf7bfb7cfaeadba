"""Integrators (parity: ``schnetpack_tpu/md/integrators.py``):
``VelocityVerlet`` and ``RingPolymer``, the exact free-ring-polymer
propagation in normal modes, and their NPT forms ``NPTVelocityVerlet``
and ``NPTRingPolymer`` (``integrators.py:100-130``), which delegate both
steps to a barostat.  ``dt`` is given in ``time_unit`` and stored in the
MD unit frame.  An NPT integrator's steps take the barostat's state as
their second argument: the simulator passes the state it owns for the
barostat among its hooks."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..units import _parse_unit, md_units
from .system import System
from .utils.normal_modes import NormalModeTransformer, normal_mode_frequencies


class VelocityVerlet:
    ring_polymer = False
    pressure_control = False

    def __init__(self, time_step: float, time_unit: str = "fs"):
        self.dt = time_step * _parse_unit(time_unit) * md_units().time

    def half_step(self, system: System) -> System:
        p = system.momenta + 0.5 * self.dt * system.forces
        return system.replace(momenta=p * system.atom_mask[None, :, None])

    def main_step(self, system: System) -> System:
        q = system.positions + self.dt * system.momenta / system.masses[None, :, None]
        return system.replace(positions=q)


class RingPolymer(VelocityVerlet):
    """RPMD: the force half steps of velocity Verlet around the exact
    evolution of the free ring polymer, mode by mode, [p'; q'] =
    [[cos, -m w sin], [sin / (m w), cos]] [p; q], and a free particle for
    the centroid (w = 0: sin / w -> dt)."""

    ring_polymer = True

    def __init__(self, time_step: float, n_beads: int, temperature: float,
                 time_unit: str = "fs"):
        super().__init__(time_step, time_unit)
        self.n_beads = n_beads
        self.temperature = temperature
        self.omega_P = n_beads * md_units().kB * temperature / md_units().hbar
        self.transformer = NormalModeTransformer(n_beads)
        omega_k = normal_mode_frequencies(n_beads, self.omega_P)
        self._np = (np.cos(omega_k * self.dt), np.sin(omega_k * self.dt),
                    omega_k)
        self._cast: Dict[tuple, Tuple[torch.Tensor, ...]] = {}

    def _coeffs(self, x: torch.Tensor):
        """(cos, w sin, sin / w) [P, 1, 1] at the dtype and device of x."""
        key = (x.dtype, x.device)
        if key not in self._cast:
            c, s, w = (torch.as_tensor(a, dtype=x.dtype, device=x.device)
                       [:, None, None] for a in self._np)
            zero = torch.zeros_like(w)
            self._cast[key] = (
                c, torch.where(w > 0, w * s, zero),
                torch.where(w > 0, s / w.clamp(min=1e-30), zero + self.dt))
        return self._cast[key]

    def main_step(self, system: System) -> System:
        m = system.masses[None, :, None]
        nm = self.transformer
        pn = nm.beads2normal(system.momenta)
        qn = nm.beads2normal(system.positions)
        c, w_sin, sin_over_w = self._coeffs(pn)
        pn_new = c * pn - w_sin * (m * qn)
        qn_new = c * qn + sin_over_w * pn / m
        return system.replace(
            momenta=nm.normal2beads(pn_new) * system.atom_mask[None, :, None],
            positions=nm.normal2beads(qn_new))


class NPTVelocityVerlet(VelocityVerlet):
    """Velocity Verlet whose steps are the barostat's
    (``integrators.py:100-115``)."""

    pressure_control = True

    def __init__(self, time_step: float, barostat, time_unit: str = "fs"):
        super().__init__(time_step, time_unit)
        self.barostat = barostat

    def half_step(self, system: System, barostat_state) -> System:
        return self.barostat.propagate_half_step(barostat_state, system,
                                                 self.dt)

    def main_step(self, system: System, barostat_state) -> System:
        return self.barostat.propagate_main_step(barostat_state, system,
                                                 self.dt)


class NPTRingPolymer(RingPolymer):
    """The ring-polymer integrator whose steps are the barostat's
    (``integrators.py:118-130``)."""

    pressure_control = True

    def __init__(self, time_step: float, n_beads: int, temperature: float,
                 barostat, time_unit: str = "fs"):
        super().__init__(time_step, n_beads, temperature, time_unit)
        self.barostat = barostat

    half_step = NPTVelocityVerlet.half_step
    main_step = NPTVelocityVerlet.main_step
