"""Ring-polymer thermostats (parity: ``schnetpack_tpu/md/simulation_hooks/
thermostats_rpmd.py``): PILE local and global (Langevin on the normal
modes; the global form rescales the centroid stochastically), TRPMD, NHC
on the normal modes, and GLE and PIGLET on the normal-mode momenta.  The
bath's kB T is multiplied by the number of beads, as in the reference.
As in ``thermostats.py``, each stochastic thermostat has a deterministic
``kick`` that takes its noise and an ``apply`` that draws it.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ...units import md_units
from ..system import System
from ..utils.normal_modes import NormalModeTransformer, normal_mode_frequencies
from ..utils.thermostat_utils import load_gle_matrices
from .thermostats import (
    NHCThermostat, ThermostatHook, gle_propagator, standard_normal,
)


@functools.lru_cache(maxsize=None)
def normal_modes(n_beads: int) -> NormalModeTransformer:
    return NormalModeTransformer(n_beads)


def _omega_P(system: System, temperature: float) -> float:
    return system.n_replicas * md_units().kB * temperature / md_units().hbar


class PILELocalThermostat(ThermostatHook):
    """Path-integral Langevin: the centroid damped with 1 / tau, internal
    mode k with gamma_k = 2 omega_k * damping_factor."""

    def __init__(self, temperature_bath: float, time_constant: float = 100.0,
                 thermostat_centroid: bool = True, damping_factor: float = 1.0):
        super().__init__(temperature_bath, time_constant)
        self.thermostat_centroid = thermostat_centroid
        self.damping_factor = damping_factor

    def init_state(self, system, dt):
        P = system.n_replicas
        gamma = 2.0 * normal_mode_frequencies(
            P, _omega_P(system, self.temperature_bath)) * self.damping_factor
        gamma[0] = (1.0 / self.time_constant) if self.thermostat_centroid else 0.0
        c1 = np.exp(-0.5 * dt * gamma)
        t = dict(dtype=system.momenta.dtype, device=system.momenta.device)
        return {"c1": torch.as_tensor(c1, **t),
                "c2": torch.as_tensor(np.sqrt(1.0 - c1 ** 2), **t)}

    def _sigma(self, system: System) -> torch.Tensor:
        kBT_P = md_units().kB * self.temperature_bath * system.n_replicas
        return torch.sqrt(system.masses * kBT_P)[None, :, None]

    def _langevin(self, state, system, pn, xi):
        return (state["c1"][:, None, None] * pn
                + state["c2"][:, None, None] * self._sigma(system) * xi)

    def kick(self, state, system: System, xi: torch.Tensor) -> System:
        nm = normal_modes(system.n_replicas)
        pn = self._langevin(state, system, nm.beads2normal(system.momenta), xi)
        p = nm.normal2beads(pn) * system.atom_mask[None, :, None]
        return system.replace(momenta=p)

    def apply(self, state, system, generator, dt):
        xi = standard_normal(system.momenta.shape, system, generator)
        return state, self.kick(state, system, xi)


class TRPMDThermostat(PILELocalThermostat):
    """Thermostatted RPMD: internal modes only, gamma_k = lambda omega_k."""

    def __init__(self, temperature_bath: float, damping_factor: float = 0.5):
        super().__init__(temperature_bath, time_constant=1e30,
                         thermostat_centroid=False,
                         damping_factor=damping_factor)


class PILEGlobalThermostat(PILELocalThermostat):
    """PILE with stochastic velocity rescaling (Bussi-Donadio-Parrinello)
    of each molecule's centroid mode.  Its noise: xi for the internal
    modes, and per molecule a normal r1 and a chi-square r2 with dof - 1
    degrees of freedom, drawn as a sum of squared normals."""

    def init_state(self, system, dt):
        state = super().init_state(system, dt)
        n_chi = (system.degrees_of_freedom - 1.0).clamp(min=0.0)
        k = int(n_chi.max())
        state["chi_mask"] = (torch.arange(k, device=n_chi.device)[None, :]
                             < n_chi[:, None]).to(system.momenta.dtype)
        return state

    def kick(self, state, system, xi, r1, r2, dt):
        nm = normal_modes(system.n_replicas)
        pn = nm.beads2normal(system.momenta)
        internal = self._langevin(state, system, pn, xi)
        kBT_P = md_units().kB * self.temperature_bath * system.n_replicas
        c1_0 = math.exp(-0.5 * dt / self.time_constant)
        p0 = pn[0]                                           # [A, 3]
        ke0 = system.sum_atoms(
            (0.5 * (p0 ** 2).sum(-1) / system.masses)[None, :, None])[0, :, 0]
        dof = system.degrees_of_freedom.clamp(min=1.0)
        ratio = 0.5 * dof * kBT_P / ke0.clamp(min=1e-12) / dof
        alpha2 = (c1_0 + (1.0 - c1_0) * ratio * (r2 + r1 ** 2)
                  + 2.0 * r1 * torch.sqrt(c1_0 * (1.0 - c1_0) * ratio))
        alpha = torch.sqrt(alpha2.clamp(min=1e-12))          # [M]
        internal[0] = p0 * alpha[system.idx_m][:, None]
        p = nm.normal2beads(internal) * system.atom_mask[None, :, None]
        return system.replace(momenta=p)

    def apply(self, state, system, generator, dt):
        xi = standard_normal(system.momenta.shape, system, generator)
        M = system.n_molecules
        r1 = standard_normal((M,), system, generator)
        chi = standard_normal(state["chi_mask"].shape, system, generator)
        r2 = (chi * chi * state["chi_mask"]).sum(-1)
        return state, self.kick(state, system, xi, r1, r2, dt)


class NHCRingPolymerThermostat(NHCThermostat):
    """Massive NHC on the ring polymer's normal modes with normal-mode
    thermostat masses.  ``local=False`` thermostats the centroid globally:
    its first link gets mass and degrees of freedom times 3N and couples
    to the molecule's whole centroid kinetic energy."""

    def __init__(self, temperature_bath: float, time_constant: float = 100.0,
                 chain_length: int = 3, local: bool = True,
                 multi_step: int = 2, integration_order: int = 3):
        super().__init__(temperature_bath, time_constant, chain_length,
                         massive=True, multi_step=multi_step,
                         integration_order=integration_order)
        self.local = local

    def _kbt(self, system):
        return md_units().kB * self.temperature_bath * system.n_replicas

    def _dof3n(self, system, dtype):
        """[A, 1]: 3N of each atom's molecule."""
        return system.expand_atoms(
            (3.0 * system.n_atoms_per_mol.to(dtype))[None, :, None])[0]

    def _dof_and_ke(self, system):
        # the system's momenta are normal-mode momenta here (see apply)
        ke2 = system.momenta ** 2 / system.masses[None, :, None]  # [P, A, 3]
        dof = torch.ones_like(ke2)
        if not self.local:
            ke2_c = system.sum_atoms(ke2[0:1].sum(2, keepdim=True))
            ke2 = ke2.clone()
            ke2[0] = system.expand_atoms(ke2_c)[0]
            dof[0] = self._dof3n(system, ke2.dtype)
        return dof, ke2

    def init_state(self, system, dt):
        freqs = normal_mode_frequencies(
            system.n_replicas, _omega_P(system, self.temperature_bath))
        freqs[0] = 0.5 / self.time_constant
        t = dict(dtype=system.momenta.dtype, device=system.momenta.device)
        q_mode = torch.as_tensor(self._kbt(system) / freqs ** 2, **t)
        shape = system.momenta.shape + (self.chain_length,)
        q = q_mode[:, None, None, None].expand(shape).clone()
        if not self.local:
            q[0, :, :, 0] = q[0, :, :, 0] * self._dof3n(system, q.dtype)
        return {"p_xi": torch.zeros(shape, **t), "xi": torch.zeros(shape, **t),
                "q": q}

    def apply(self, state, system, generator, dt):
        nm = normal_modes(system.n_replicas)
        state, tmp = super().apply(
            state, system.replace(momenta=nm.beads2normal(system.momenta)),
            generator, dt)
        p = nm.normal2beads(tmp.momenta) * system.atom_mask[None, :, None]
        return state, system.replace(momenta=p)


class RPMDGLEThermostat(ThermostatHook):
    """GLE on the ring polymer's normal-mode momenta at the bead-scaled
    temperature: one (A, C) pair for every mode."""

    def __init__(self, temperature_bath: float, gle_file: str):
        super().__init__(temperature_bath, time_constant=1.0)
        self._a, self._c = load_gle_matrices(gle_file)
        if self._a is None:
            raise ValueError(f"Could not parse A matrix from {gle_file}")

    def _mode_propagators(self, system, dt):
        """Per-normal-mode (T, S) stacks [P, s, s]."""
        P = system.n_replicas
        if self._a.shape[0] != 1:
            raise ValueError(
                "RPMDGLEThermostat expects a single A matrix; per-normal-mode "
                "files are handled by PIGLETThermostat")
        T, S = gle_propagator(self._a[0], self._c_of(0, P), 0.5 * dt)
        return (np.broadcast_to(T, (P,) + T.shape),
                np.broadcast_to(S, (P,) + S.shape))

    def _c_of(self, section: int, P: int) -> np.ndarray:
        n = self._a.shape[-1]
        if self._c is None:
            return md_units().kB * self.temperature_bath * P * np.eye(n)
        return self._c[section]

    def init_state(self, system, dt):
        T, S = self._mode_propagators(system, dt)
        t = dict(dtype=system.momenta.dtype, device=system.momenta.device)
        n_aux = self._a.shape[-1] - 1
        return {"s": torch.zeros(system.momenta.shape + (n_aux,), **t),
                "T": torch.as_tensor(np.ascontiguousarray(T), **t),
                "S": torch.as_tensor(np.ascontiguousarray(S), **t)}

    def kick(self, state, system: System, xi: torch.Tensor):
        nm = normal_modes(system.n_replicas)
        pn = nm.beads2normal(system.momenta)                 # [P, A, 3]
        sqrt_m = torch.sqrt(system.masses)[None, :, None]
        vec = torch.cat([(pn / sqrt_m)[..., None], state["s"]], -1)
        new = (torch.einsum("pij,pakj->paki", state["T"], vec)
               + torch.einsum("pij,pakj->paki", state["S"], xi))
        p = nm.normal2beads(new[..., 0] * sqrt_m) * system.atom_mask[None, :, None]
        return {**state, "s": new[..., 1:]}, system.replace(momenta=p)

    def apply(self, state, system, generator, dt):
        xi = standard_normal(
            system.momenta.shape + (state["s"].shape[-1] + 1,), system,
            generator)
        return self.kick(state, system, xi)


class PIGLETThermostat(RPMDGLEThermostat):
    """PIGLET: a distinct GLE drift and diffusion pair for each normal
    mode, from a multi-section gle4md file (Uhl, Marx, Ceriotti 2016)."""

    def _mode_propagators(self, system, dt):
        P = system.n_replicas
        if self._a.shape[0] != P:
            raise ValueError(
                f"PIGLET file provides {self._a.shape[0]} normal-mode "
                f"matrices but the ring polymer has {P} beads")
        Ts, Ss = zip(*(gle_propagator(self._a[b], self._c_of(b, P), 0.5 * dt)
                       for b in range(P)))
        return np.stack(Ts), np.stack(Ss)

