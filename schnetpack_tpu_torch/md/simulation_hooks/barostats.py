"""Barostats for NPT MD (parity: ``schnetpack_tpu/md/simulation_hooks/
barostats.py``): the isotropic and the fully flexible Martyna-Tobias-Klein
barostats with Nose-Hoover chains, and the stochastic ``PILEBarostat`` of
ring-polymer NPT.

A barostat is a device hook and the propagator of the NPT integrators at
once.  ``apply`` (before the first and after the last half step) runs the
particle chain, the cell momentum's own thermostat and half a kick of the
cell momentum; ``propagate_half_step`` and ``propagate_main_step`` are the
integrator's steps, on the cell momentum of the state the simulator hands
them (the JAX package passes it through ``_live_state``,
``barostats.py:111-112, 131-152``).  The isotropic cell momentum v_eps is
[R, M]; the anisotropic one v_g [R, M, 3, 3], symmetric, whose matrix
exponentials come from ``torch.linalg.eigh`` of the 3 x 3 blocks.
``PILEBarostat`` draws its noise in ``apply`` and applies it in ``kick``,
so a test can feed ``kick`` the noise JAX drew.
"""
from __future__ import annotations

import math

import torch

from ...ops.math import stable_sinh_div
from ...units import _parse_unit, md_units
from ..system import System
from .thermostats import NHCThermostat, ThermostatHook, standard_normal


class BarostatHook(ThermostatHook):
    """Base: ``target_pressure`` [bar], ``temperature_bath`` [K],
    ``time_constant`` [fs]."""

    ring_polymer = False

    def __init__(self, target_pressure: float, temperature_bath: float,
                 time_constant: float = 1000.0):
        super().__init__(temperature_bath, time_constant)
        self.target_pressure = (target_pressure * _parse_unit("bar")
                                * md_units().pressure)

    def propagate_half_step(self, state, system: System,
                            dt: float) -> System:
        raise NotImplementedError

    def propagate_main_step(self, state, system: System,
                            dt: float) -> System:
        raise NotImplementedError


def _dof(system: System) -> torch.Tensor:
    """[1, M] degrees of freedom, at least 1."""
    return system.degrees_of_freedom[None, :].clamp(min=1.0)


class NHCBarostatIsotropic(BarostatHook):
    """Isotropic MTK barostat; the particles and the cell momentum each
    under a Nose-Hoover thermostat (``barostats.py:47-153``)."""

    def __init__(self, target_pressure: float, temperature_bath: float,
                 time_constant: float = 100.0,
                 time_constant_cell: float = 1000.0,
                 time_constant_barostat: float = 1000.0,
                 chain_length: int = 4, multi_step: int = 4,
                 integration_order: int = 7):
        super().__init__(target_pressure, temperature_bath, time_constant)
        self.particle_nhc = NHCThermostat(
            temperature_bath, time_constant, chain_length, massive=False,
            multi_step=multi_step, integration_order=integration_order)
        fs = md_units().time * _parse_unit("fs")
        self.tau_b = time_constant_barostat * fs
        self.tau_cell = time_constant_cell * fs

    def _kbt(self) -> float:
        return md_units().kB * self.temperature_bath

    def _g_eps(self, state, system: System) -> torch.Tensor:
        """The cell momentum's force [R, M]: (3 V (P_int - P_ext) + 3 / dof
        2 KE) / W."""
        V = system.volume.clamp(min=1e-12)
        ke2 = 2.0 * system.kinetic_energy
        return (3.0 * V * (system.pressure - self.target_pressure)
                + (3.0 / _dof(system)) * ke2) / state["W"]

    def propagate_half_step(self, state, system, dt):
        a = ((1.0 + 3.0 / _dof(system))
             * system.expand_atoms(state["v_eps"][..., None]))  # [R, A, 1]
        decay = torch.exp(-0.5 * dt * a)
        kick = torch.exp(-0.25 * dt * a) * stable_sinh_div(0.25 * dt * a)
        p = system.momenta * decay + 0.5 * dt * system.forces * kick
        return system.replace(momenta=p * system.atom_mask[None, :, None])

    def propagate_main_step(self, state, system, dt):
        v_eps = state["v_eps"]
        a = system.expand_atoms(v_eps[..., None])             # [R, A, 1]
        drift = torch.exp(0.5 * dt * a) * stable_sinh_div(0.5 * dt * a)
        q = (system.positions * torch.exp(dt * a)
             + dt * system.momenta / system.masses[None, :, None] * drift)
        cells = system.cells * torch.exp(dt * v_eps)[..., None, None]
        return system.replace(positions=q, cells=cells)

    def init_state(self, system, dt):
        t = dict(dtype=system.momenta.dtype, device=system.momenta.device)
        shape = system.energy.shape
        W = ((system.degrees_of_freedom[None, :] + 3.0) * self._kbt()
             * self.tau_b ** 2)
        return {
            "particle_nhc": self.particle_nhc.init_state(system, dt),
            "v_eps": torch.zeros(shape, **t),
            "W": W.expand(shape).to(**t).clone(),
            "xi_cell": torch.zeros(shape, **t),
            "q_cell": torch.full(shape, self._kbt() * self.tau_cell ** 2,
                                 **t),
        }

    def apply(self, state, system, generator, dt):
        kBT = self._kbt()
        nhc_state, system = self.particle_nhc.apply(
            state["particle_nhc"], system, generator, dt)
        v_eps, W = state["v_eps"], state["W"]
        xi, q = state["xi_cell"], state["q_cell"]
        # Nose-Hoover on the cell momentum, then half a kick of it
        xi = xi + 0.25 * dt * (W * v_eps ** 2 - kBT) / q
        v_eps = v_eps * torch.exp(-0.5 * dt * xi)
        xi = xi + 0.25 * dt * (W * v_eps ** 2 - kBT) / q
        v_eps = v_eps + 0.5 * dt * self._g_eps(state, system)
        return {**state, "particle_nhc": nhc_state, "v_eps": v_eps,
                "xi_cell": xi}, system


def _sym_expm_weighted(v: torch.Tensor, dt: float):
    """exp(dt v) and its sinh(x)/x-weighted form exp(dt v / 2)
    sinh(dt v / 2) / (dt v / 2) of symmetric [..., 3, 3] matrices, from
    their eigendecomposition (``barostats.py:156-167``)."""
    w, U = torch.linalg.eigh(v)
    expm = torch.einsum("...ik,...k,...jk->...ij", U, torch.exp(dt * w), U)
    weight = torch.exp(0.5 * dt * w) * stable_sinh_div(0.5 * dt * w)
    return expm, torch.einsum("...ik,...k,...jk->...ij", U, weight, U)


class NHCBarostatAnisotropic(NHCBarostatIsotropic):
    """Fully flexible cell: a symmetric cell momentum v_g [R, M, 3, 3]
    (``barostats.py:170-264``)."""

    def init_state(self, system, dt):
        state = super().init_state(system, dt)
        state["v_g"] = torch.zeros(system.energy.shape + (3, 3),
                                   dtype=system.momenta.dtype,
                                   device=system.momenta.device)
        return state

    def _g_g(self, state, system: System) -> torch.Tensor:
        """(V (P_int - P_ext I) + 2 KE / dof I) / W, P_int the kinetic
        pressure tensor less the stress."""
        V = system.volume.clamp(min=1e-12)[..., None, None]
        eye = torch.eye(3, dtype=system.momenta.dtype,
                        device=system.momenta.device)
        p_int = 2.0 * system.kinetic_energy_tensor / V - system.stress
        ke2 = (2.0 * system.kinetic_energy / _dof(system))[..., None, None]
        return ((V * (p_int - self.target_pressure * eye) + ke2 * eye)
                / state["W"][..., None, None])

    def apply(self, state, system, generator, dt):
        kBT = self._kbt()
        nhc_state, system = self.particle_nhc.apply(
            state["particle_nhc"], system, generator, dt)
        v_g, W = state["v_g"], state["W"]
        xi, q = state["xi_cell"], state["q_cell"]
        Wg = W[..., None, None]
        # Nose-Hoover on the cell momentum's kinetic energy (9 dof)
        xi = xi + 0.25 * dt * ((Wg * v_g * v_g).sum((-2, -1)) - 9.0 * kBT) / q
        v_g = v_g * torch.exp(-0.5 * dt * xi)[..., None, None]
        xi = xi + 0.25 * dt * ((Wg * v_g * v_g).sum((-2, -1)) - 9.0 * kBT) / q
        v_g = v_g + 0.5 * dt * self._g_g(state, system)
        v_g = 0.5 * (v_g + v_g.transpose(-1, -2))
        return {**state, "particle_nhc": nhc_state, "v_g": v_g,
                "xi_cell": xi}, system

    def propagate_half_step(self, state, system, dt):
        v_g = state["v_g"]
        eye = torch.eye(3, dtype=v_g.dtype, device=v_g.device)
        trace = torch.diagonal(v_g, dim1=-2, dim2=-1).sum(-1)
        v_eff = v_g + (trace / _dof(system))[..., None, None] * eye
        decay, kick = _sym_expm_weighted(-v_eff, 0.5 * dt)
        p = (torch.einsum("raij,raj->rai", system.expand_atoms(decay),
                          system.momenta)
             + 0.5 * dt * torch.einsum("raij,raj->rai",
                                       system.expand_atoms(kick),
                                       system.forces))
        return system.replace(momenta=p * system.atom_mask[None, :, None])

    def propagate_main_step(self, state, system, dt):
        grow, drift = _sym_expm_weighted(state["v_g"], dt)
        v = system.momenta / system.masses[None, :, None]
        q = (torch.einsum("raij,raj->rai", system.expand_atoms(grow),
                          system.positions)
             + dt * torch.einsum("raij,raj->rai", system.expand_atoms(drift),
                                 v))
        cells = torch.einsum("rmij,rmkj->rmki", grow, system.cells)
        return system.replace(positions=q, cells=cells)


class PILEBarostat(BarostatHook):
    """Stochastic isotropic barostat of ring-polymer NPT
    (``barostats.py:267-303``): a Langevin update of the cell momentum,
    v_eps' = c1 v_eps + sqrt((1 - c1^2) P kB T / W) xi, with the
    isotropic barostat's propagation.  As in the JAX package, ``apply``
    does not add the cell force."""

    ring_polymer = True

    def __init__(self, target_pressure: float, temperature_bath: float,
                 time_constant: float = 1000.0):
        super().__init__(target_pressure, temperature_bath, time_constant)

    def init_state(self, system, dt):
        kBT_P = md_units().kB * self.temperature_bath * system.n_replicas
        W = ((system.degrees_of_freedom[None, :] + 3.0) * kBT_P
             * self.time_constant ** 2)
        t = dict(dtype=system.momenta.dtype, device=system.momenta.device)
        return {"v_eps": torch.zeros(system.energy.shape, **t),
                "W": W.expand(system.energy.shape).to(**t).clone()}

    def kick(self, state, system: System, xi: torch.Tensor, dt: float):
        kBT_P = md_units().kB * self.temperature_bath * system.n_replicas
        c1 = math.exp(-0.5 * dt / self.time_constant)
        c2 = torch.sqrt((1.0 - c1 ** 2) * kBT_P / state["W"])
        return {**state, "v_eps": c1 * state["v_eps"] + c2 * xi}, system

    def apply(self, state, system, generator, dt):
        xi = standard_normal(state["v_eps"].shape, system, generator)
        return self.kick(state, system, xi, dt)

    propagate_half_step = NHCBarostatIsotropic.propagate_half_step
    propagate_main_step = NHCBarostatIsotropic.propagate_main_step
