"""Thermostats (parity: ``schnetpack_tpu/md/simulation_hooks/
thermostats.py``): Berendsen, Langevin (exact Ornstein-Uhlenbeck update),
Nose-Hoover chains (Yoshida-Suzuki multi-step, ``massive`` option) and
GLE (i-PI matrix files).

Every thermostat is a device hook, ``apply(state, system, generator, dt)
-> (state, system)``, run before the first and after the last half step
of each MD step with the step's ``dt``, so each application couples over
dt / 2.  Its state is a dict of tensors, as in the JAX package.  A
stochastic thermostat splits into a deterministic update that takes the
noise (``kick``) and an ``apply`` that draws it with ``torch.randn`` from
the generator, on the system's device: ``jax.random``'s bits cannot be
reproduced, so the tests feed ``kick`` the noise that JAX drew.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import numpy as np
import torch

from ...units import _parse_unit, md_units
from ..system import System
from ..utils.thermostat_utils import load_gle_matrices, ys_weights


def standard_normal(shape, system: System,
                    generator: torch.Generator) -> torch.Tensor:
    """N(0, 1) noise of ``shape`` in the system's dtype, drawn on the
    system's device, which must be the generator's."""
    return torch.randn(shape, generator=generator,
                       dtype=system.momenta.dtype,
                       device=system.momenta.device)


class ThermostatHook:
    """Base: ``temperature_bath`` [K], ``time_constant`` [fs]."""

    def __init__(self, temperature_bath: float, time_constant: float = 100.0):
        self.temperature_bath = temperature_bath
        self.time_constant = time_constant * md_units().time * _parse_unit("fs")

    def init_state(self, system: System, dt: float) -> Any:
        return None

    def apply(self, state, system: System, generator: torch.Generator,
              dt: float) -> Tuple[Any, System]:
        raise NotImplementedError


class BerendsenThermostat(ThermostatHook):
    """Velocity rescaling toward the bath temperature."""

    def apply(self, state, system, generator, dt):
        T = system.temperature                               # [R, M]
        scale = torch.sqrt(1.0 + 0.5 * dt / self.time_constant * (
            self.temperature_bath / T.clamp(min=1e-9) - 1.0))
        p = system.momenta * system.expand_atoms(scale[..., None])
        return state, system.replace(momenta=p * system.atom_mask[None, :, None])


class LangevinThermostat(ThermostatHook):
    """p' = c1 p + sqrt(m kB T) c2 xi, c1 = exp(-dt / (2 tau))."""

    def kick(self, system: System, xi: torch.Tensor, dt: float) -> System:
        c1 = math.exp(-0.5 * dt / self.time_constant)
        c2 = math.sqrt(1.0 - c1 ** 2)
        sigma = torch.sqrt(system.masses * (md_units().kB
                                            * self.temperature_bath))
        p = c1 * system.momenta + c2 * sigma[None, :, None] * xi
        return system.replace(momenta=p * system.atom_mask[None, :, None])

    def apply(self, state, system, generator, dt):
        xi = standard_normal(system.momenta.shape, system, generator)
        return state, self.kick(system, xi, dt)


class NHCThermostat(ThermostatHook):
    """Nose-Hoover chains with Yoshida-Suzuki multi-step integration.
    ``massive=False``: one chain per molecule (on its kinetic energy);
    ``massive=True``: one chain per degree of freedom.  The state holds
    the chains' momenta ``p_xi``, masses ``q`` and positions ``xi``; only
    ``chain_energy`` reads the positions.  A chain per molecule is a few
    hundred scalar updates an application: they run on the host as Python
    floats, on one copy each way, instead of as that many launches."""

    def __init__(self, temperature_bath: float, time_constant: float = 100.0,
                 chain_length: int = 3, massive: bool = False,
                 multi_step: int = 2, integration_order: int = 3):
        super().__init__(temperature_bath, time_constant)
        self.chain_length = chain_length
        self.massive = massive
        self.multi_step = multi_step
        self.ys = [float(w) for w in ys_weights(integration_order)]

    def _kbt(self, system: System) -> float:
        return md_units().kB * self.temperature_bath

    def _dof_and_ke(self, system: System):
        """(degrees of freedom, twice the kinetic energy) per chain."""
        if self.massive:
            ke2 = system.momenta ** 2 / system.masses[None, :, None]
            return torch.ones_like(ke2), ke2
        ke2 = 2.0 * system.kinetic_energy                    # [R, M]
        return system.degrees_of_freedom[None, :].expand_as(ke2), ke2

    def init_state(self, system, dt):
        shape = (system.momenta.shape if self.massive
                 else system.energy.shape) + (self.chain_length,)
        dof, _ = self._dof_and_ke(system)
        dtype, dev = system.momenta.dtype, system.momenta.device
        # thermostat masses: Q_0 = dof kBT tau^2, Q_k = kBT tau^2
        q = torch.full(shape, self._kbt(system) * self.time_constant ** 2,
                       dtype=dtype, device=dev)
        q[..., 0] = q[..., 0] * dof
        zeros = torch.zeros(shape, dtype=dtype, device=dev)
        return {"p_xi": zeros, "xi": zeros.clone(), "q": q}

    def _chain(self, p, xi, q, ke2, dof, kBT, dt, exp):
        """One application (dt / 2) of a chain whose links' momenta ``p``,
        positions ``xi`` and masses ``q`` are lists of floats or of
        tensors alike; returns the new ``p`` and ``xi`` and the scale of
        the thermostatted momenta."""
        p, xi = list(p), list(xi)
        n = self.chain_length
        scale = 1.0

        def force(k):
            """G_k: the chain's thermostat force on link k."""
            if k == 0:
                return ke2 * scale ** 2 - dof * kBT
            return p[k - 1] ** 2 / q[k - 1] - kBT

        def link(k, delta):
            coeff = exp(-0.125 * delta * p[k + 1] / q[k + 1])
            p[k] = coeff * (coeff * p[k] + 0.25 * delta * force(k))

        for _ in range(self.multi_step):
            for w in self.ys:
                delta = w * dt / self.multi_step
                # the chain from its tail inward
                p[n - 1] = p[n - 1] + 0.25 * delta * force(n - 1)
                for k in range(n - 2, -1, -1):
                    link(k, delta)
                scale = scale * exp(-0.5 * delta * p[0] / q[0])
                xi = [x + 0.5 * delta * pk / qk for x, pk, qk in zip(xi, p, q)]
                # and outward
                for k in range(0, n - 1):
                    link(k, delta)
                p[n - 1] = p[n - 1] + 0.25 * delta * force(n - 1)
        return p, xi, scale

    def apply(self, state, system, generator, dt):
        kBT = self._kbt(system)
        q = state["q"]
        dof, ke2 = self._dof_and_ke(system)
        if self.massive:
            p, xi, scale = self._chain(
                state["p_xi"].unbind(-1), state["xi"].unbind(-1),
                q.unbind(-1), ke2, dof, kBT, dt, torch.exp)
            p_xi, xi = torch.stack(p, -1), torch.stack(xi, -1)
            p = system.momenta * scale
        else:
            n = self.chain_length
            host = torch.cat([ke2[..., None], dof[..., None], q,
                              state["p_xi"], state["xi"]], -1)
            out = []
            for ke2_c, dof_c, *c in host.to("cpu", torch.float64).reshape(
                    -1, 2 + 3 * n).tolist():
                p_c, xi_c, s = self._chain(c[n:2 * n], c[2 * n:], c[:n],
                                           ke2_c, dof_c, kBT, dt, math.exp)
                out.append([s, *p_c, *xi_c])
            back = torch.tensor(out, dtype=q.dtype, device=q.device).reshape(
                ke2.shape + (1 + 2 * n,))
            scale, p_xi, xi = back[..., 0], back[..., 1:1 + n], back[..., 1 + n:]
            p = system.momenta * system.expand_atoms(scale[..., None])
        system = system.replace(momenta=p * system.atom_mask[None, :, None])
        return {"p_xi": p_xi, "xi": xi, "q": q}, system

    def chain_energy(self, state, system: System) -> torch.Tensor:
        """The chains' share of the conserved extended energy, summed
        over every chain (float64): sum_k p_xi_k^2 / (2 Q_k) + dof kBT
        xi_0 + kBT sum_{k>0} xi_k.  With the kinetic and potential energy
        it stays constant along an NHC trajectory."""
        kBT = self._kbt(system)
        dof, _ = self._dof_and_ke(system)
        p, q, xi = (state[k].double() for k in ("p_xi", "q", "xi"))
        return ((0.5 * p * p / q).sum()
                + kBT * (dof.double() * xi[..., 0]).sum()
                + kBT * xi[..., 1:].sum())


def gle_propagator(a: np.ndarray, c: np.ndarray, dt_half: float):
    """(T, S) with T = expm(-dt/2 A) and S S^T = C - T C T^T (symmetrised,
    negative eigenvalues clipped)."""
    import scipy.linalg

    T = scipy.linalg.expm(-dt_half * a)
    S2 = c - T @ c @ T.T
    S2 = 0.5 * (S2 + S2.T)
    w, v = np.linalg.eigh(S2)
    return T, v @ np.diag(np.sqrt(np.maximum(w, 0.0))) @ v.T


class GLEThermostat(ThermostatHook):
    """Colored-noise generalized Langevin thermostat from an i-PI matrix
    file.  State: auxiliary momenta s [R, A, 3, n_aux]; the update is
    (p / sqrt(m), s) -> T (p / sqrt(m), s) + S xi."""

    def __init__(self, temperature_bath: float, gle_file: str):
        super().__init__(temperature_bath, time_constant=1.0)
        a, c = load_gle_matrices(gle_file)
        if a is None:
            raise ValueError(f"Could not parse A matrix from {gle_file}")
        if a.shape[0] > 1:
            raise ValueError(
                "More than one A matrix found — this looks like a PIGLET "
                "input; use PIGLETThermostat")
        self._a = a[0]
        self._c = c[0] if c is not None else None

    def init_state(self, system, dt):
        n = self._a.shape[-1]
        c = (md_units().kB * self.temperature_bath * np.eye(n)
             if self._c is None else self._c)
        T, S = gle_propagator(self._a, c, 0.5 * dt)
        t = dict(dtype=system.momenta.dtype, device=system.momenta.device)
        return {"s": torch.zeros(system.momenta.shape + (n - 1,), **t),
                "T": torch.as_tensor(T, **t), "S": torch.as_tensor(S, **t)}

    def kick(self, state, system: System, xi: torch.Tensor):
        sqrt_m = torch.sqrt(system.masses)[None, :, None]
        vec = torch.cat([(system.momenta / sqrt_m)[..., None], state["s"]], -1)
        new = (torch.einsum("ij,rakj->raki", state["T"], vec)
               + torch.einsum("ij,rakj->raki", state["S"], xi))
        p = new[..., 0] * sqrt_m * system.atom_mask[None, :, None]
        return {**state, "s": new[..., 1:]}, system.replace(momenta=p)

    def apply(self, state, system, generator, dt):
        xi = standard_normal(
            system.momenta.shape + (state["s"].shape[-1] + 1,), system,
            generator)
        return self.kick(state, system, xi)
