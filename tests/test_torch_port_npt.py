"""PyTorch port, NPT on the CPU against the JAX package, in float64:

* ``stable_sinh_div`` on both sides of its series' threshold;
* SPC/Fw energy, forces and stress against the JAX calculator (the stress
  against the strain derivative of the JAX calculator's own energy, which
  computes none) on a water cluster and on a 64-water box, whose 12.4 A
  edge keeps the 6 A cutoff under half the box, where the JAX all-pairs
  minimum image and the port's cell list see the same pairs;
* 50 steps of LJ argon (``test_npt_gle.py::argon_fcc`` at 3 x 3 x 3
  cells, 108 atoms, so that the box stays over twice the 5 A cutoff as it
  shrinks and the JAX minimum image sees every pair the port's cell list
  sees) under ``NHCBarostatIsotropic`` and ``NHCBarostatAnisotropic`` with
  ``NPTVelocityVerlet``, and 4 beads under ``NPTRingPolymer``, against
  the JAX ``Simulator`` from the same momenta, at ``test_npt_gle.py``'s
  20 kbar;
* one ``PILEBarostat`` application: ``kick`` fed the noise that
  ``jax.random.normal`` draws from the key of JAX's ``apply``, then the
  barostat's half and main steps;
* an NPT restart: 20 steps equal 10, a ``Checkpoint``, a restart into a
  fresh simulator and 10 more, bit for bit, the integrator reading the
  restored barostat state;
* an NPT integrator with a column-layout calculator raises at once.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.md import NPTRingPolymer as JNPTRingPolymer
from schnetpack_tpu.md import NPTVelocityVerlet as JNPTVelocityVerlet
from schnetpack_tpu.md import Simulator as JSimulator
from schnetpack_tpu.md import load_molecules as jload_molecules
from schnetpack_tpu.md import simulation_hooks as jhooks
from schnetpack_tpu.md.calculators import LJCalculator as JLJCalculator
from schnetpack_tpu.md.calculators import SPCFwCalculator as JSPCFw
from schnetpack_tpu.ops.math import stable_sinh_div as jstable_sinh_div
from schnetpack_tpu_torch.md import (
    NPTRingPolymer, NPTVelocityVerlet, Simulator, load_molecules,
)
from schnetpack_tpu_torch.md import simulation_hooks as hooks
from schnetpack_tpu_torch.md.calculators import LJCalculator, SPCFwCalculator
from schnetpack_tpu_torch.ops.math import stable_sinh_div
from schnetpack_tpu_torch.units import md_units

DT = 1.0              # fs, as test_npt_gle.py
N_STEPS = 50
# float64 trajectories: the two packages' sums, exps and eigensolvers
# differ in the last bits, which 50 steps amplify
TRAJ_ATOL = 1e-10
KICK_ATOL = 1e-12
# test_npt_gle.py's barostat; a shorter particle chain integration than
# the default 4 x 7 Yoshida-Suzuki substeps keeps JAX's trace small
BARO = dict(target_pressure=20000.0, temperature_bath=20.0,
            time_constant=20.0, time_constant_barostat=50.0, multi_step=2,
            integration_order=3)


@pytest.fixture(autouse=True)
def _one_thread_x64():
    torch.set_num_threads(1)
    with jax.enable_x64(True):
        yield


def argon_fcc(reps=2, a=5.26, jitter=0.05, seed=0):
    """``test_npt_gle.py::argon_fcc``, displaced by a seeded jitter."""
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    pos = np.concatenate([(base + [i, j, k]) * a for i in range(reps)
                          for j in range(reps) for k in range(reps)])
    pos = pos + jitter * np.random.RandomState(seed).randn(*pos.shape)
    return {P.Z: np.full(len(pos), 18), P.R: pos, P.cell: np.eye(3) * a * reps,
            P.pbc: np.ones(3, bool)}


def water(n_side, a=3.105, periodic=True, seed=2):
    """n_side^3 bent waters (O, H, H) on a lattice, displaced a little."""
    rng = np.random.RandomState(seed)
    pos = []
    for i in range(n_side):
        for j in range(n_side):
            for k in range(n_side):
                O = np.array([i, j, k], float) * a + a / 2
                pos += [O, O + [0.76, 0.67, 0.0], O + [-0.76, 0.67, 0.0]]
    pos = np.asarray(pos) + 0.05 * rng.randn(len(pos), 3)
    Z = np.tile([8, 1, 1], n_side ** 3)
    cell = np.eye(3) * a * n_side if periodic else np.zeros((3, 3))
    return {P.Z: Z, P.R: pos, P.cell: cell, P.pbc: np.full(3, periodic)}


def momenta(mol, n_replicas=1, temperature=20.0, seed=1):
    masses = 39.948 * md_units().mass
    sigma = np.sqrt(masses * md_units().kB * temperature)
    p = sigma * np.random.RandomState(seed).randn(n_replicas, len(mol[P.R]),
                                                  3)
    return p - p.mean(axis=1, keepdims=True)


def systems(mol, n_replicas=1, p=None):
    js = jload_molecules([mol], n_replicas=n_replicas, dtype=jnp.float64)
    s = load_molecules([mol], n_replicas=n_replicas, dtype=torch.float64,
                       device="cpu")
    if p is not None:
        js = js.replace(momenta=jnp.asarray(p))
        s = s.replace(momenta=torch.tensor(p))
    return js, s


def lj(module, cutoff=5.0):
    return module(r_equilibrium=3.82, well_depth=0.0103, cutoff=cutoff,
                  calc_stress=True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stable_sinh_div(dtype):
    x = np.concatenate([np.linspace(-2e-4, 2e-4, 41), [-3.0, -0.5, 0.0, 0.7,
                                                       4.0]]).astype(dtype)
    got = stable_sinh_div(torch.tensor(x)).numpy()
    want = np.asarray(jstable_sinh_div(jnp.asarray(x)))
    assert got.dtype == dtype
    # float32: the two packages round sinh and the series an ulp apart
    np.testing.assert_allclose(got, want, rtol=1e-15 if dtype == np.float64
                               else 2.5e-7)


@pytest.mark.parametrize("case", ["cluster", "box"])
def test_spcfw_energy_forces_stress_match_jax(case):
    mol = water(2, periodic=False) if case == "cluster" else water(4)
    js, s = systems(mol)
    got = SPCFwCalculator(calc_stress=True).calculate(s)
    jcalc = JSPCFw()
    want = jcalc.calculate(js)
    for k in ("energy", "forces"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    assert np.abs(got.forces.numpy()).max() > 1.0

    # the stress: d E / d strain over the volume of the JAX energy
    inputs = jcalc._get_system_molecules(js)
    pairs = jcalc._pair_inputs(js)
    R0, cells = inputs[P.R], inputs[P.cell]
    idx_m, mask = inputs[P.idx_m], inputs[P.atom_mask]

    def strained_energy(eps):
        off = pairs[P.offsets]
        strained = dict(pairs, **{P.offsets: off + off @ eps})
        return jnp.sum(jcalc._energy(R0 + R0 @ eps, strained, idx_m, 1, mask,
                                     cells + cells @ eps))

    dE = jax.grad(strained_energy)(jnp.zeros((3, 3)))
    if case == "box":
        sigma = np.asarray(dE) / abs(np.linalg.det(np.asarray(cells[0])))
        want_stress = 0.5 * (sigma + sigma.T) * jcalc.stress_conversion
        np.testing.assert_allclose(got.stress.numpy()[0, 0], want_stress,
                                   rtol=1e-10, atol=1e-14)
        assert np.abs(want_stress).max() > 1e-6


def _npt_hooks(module, name):
    if name == "aniso":
        return module.NHCBarostatAnisotropic(**BARO)
    return module.NHCBarostatIsotropic(**BARO)


@pytest.mark.parametrize("name", ["iso", "aniso", "rp_iso"])
def test_npt_trajectory_matches_jax(name):
    n_rep = 4 if name == "rp_iso" else 1
    mol = argon_fcc(reps=3)
    p = momenta(mol, n_rep)
    if n_rep > 1:       # beads spread a little about the same atoms
        conv = md_units().length
        R = (mol[P.R][None] + 0.03 * np.random.RandomState(4).randn(
            n_rep, len(mol[P.R]), 3)) * conv
    js, s = systems(mol, n_rep, p)
    if n_rep > 1:
        js = js.replace(positions=jnp.asarray(R))
        s = s.replace(positions=torch.tensor(R))
    jb, b = _npt_hooks(jhooks, name), _npt_hooks(hooks, name)
    if n_rep > 1:
        jint = JNPTRingPolymer(DT, n_rep, 20.0, jb)
        integ = NPTRingPolymer(DT, n_rep, 20.0, b)
    else:
        jint, integ = JNPTVelocityVerlet(DT, jb), NPTVelocityVerlet(DT, b)
    jsim = JSimulator(js, jint, lj(JLJCalculator), simulator_hooks=[jb],
                      progress=False, log_keys=("energy",))
    jsim.simulate(N_STEPS, chunk_size=N_STEPS)
    sim = Simulator(s, integ, lj(LJCalculator), simulator_hooks=[b],
                    log_keys=("energy",))
    sim.simulate(N_STEPS, chunk_size=25)
    want = jsim.state.system
    for k in ("positions", "momenta", "cells", "energy"):
        np.testing.assert_allclose(getattr(sim.system, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=TRAJ_ATOL, err_msg=k)
    key = "v_g" if name == "aniso" else "v_eps"
    np.testing.assert_allclose(sim.hook_states[0][key].numpy(),
                               np.asarray(jsim.state.hook_states[0][key]),
                               rtol=1e-9, atol=1e-14)
    # the box moved: the barostat acted
    v0 = abs(np.linalg.det(mol[P.cell])) * md_units().length ** 3
    assert float(sim.system.volume[0, 0]) < 0.999 * v0


def test_pile_barostat_kick_matches_jax():
    n_rep = 4
    mol = argon_fcc()
    js, s = systems(mol, n_rep, momenta(mol, n_rep))
    jcalc, calc = lj(JLJCalculator), lj(LJCalculator)
    js, s = jcalc.calculate(js), calc.calculate(s)
    jb = jhooks.PILEBarostat(20000.0, 20.0, time_constant=100.0)
    b = hooks.PILEBarostat(20000.0, 20.0, time_constant=100.0)
    dt = NPTVelocityVerlet(DT, b).dt
    jstate = jb.init_state(js, dt)
    state = b.init_state(s, dt)
    key = jax.random.PRNGKey(3)
    jstate, _ = jb.apply(jstate, js, key, dt)
    xi = jax.random.normal(key, jstate["v_eps"].shape, jnp.float64)
    state, _ = b.kick(state, s, torch.tensor(np.asarray(xi)), dt)
    np.testing.assert_allclose(state["v_eps"].numpy(),
                               np.asarray(jstate["v_eps"]), rtol=0,
                               atol=KICK_ATOL)
    assert np.abs(np.asarray(jstate["v_eps"])).max() > 0
    js2 = jb.propagate_main_step(js, dt)
    js2 = jb.propagate_half_step(js2, dt)
    s2 = b.propagate_main_step(state, s, dt)
    s2 = b.propagate_half_step(state, s2, dt)
    for k in ("positions", "momenta", "cells"):
        np.testing.assert_allclose(getattr(s2, k).numpy(),
                                   np.asarray(getattr(js2, k)), rtol=1e-13,
                                   atol=1e-15, err_msg=k)
    # apply draws from the simulator's generator
    g = torch.Generator().manual_seed(0)
    state2, _ = b.apply(b.init_state(s, dt), s, g, dt)
    assert torch.isfinite(state2["v_eps"]).all()


@pytest.mark.parametrize("name", ["iso", "aniso"])
def test_npt_restart_is_bitwise(tmp_path, name):
    """20 steps equal 10, a checkpoint, a restart into a fresh simulator
    (whose barostat's own state is the initial one) and 10 more, bit for
    bit."""
    mol = argon_fcc()
    p = momenta(mol)

    def make(extra=()):
        _, s = systems(mol, 1, p)
        b = _npt_hooks(hooks, name)
        return Simulator(s, NPTVelocityVerlet(DT, b), lj(LJCalculator),
                         simulator_hooks=[b, *extra], seed=5)

    whole = make()
    whole.simulate(20, chunk_size=5)
    path = str(tmp_path / "state.pkl")
    first = make([hooks.Checkpoint(path, every_n_steps=10)])
    first.simulate(10, chunk_size=5)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    second = make()
    second.restart_simulation(saved)
    second.simulate(10, chunk_size=5)
    for k in ("positions", "momenta", "cells", "energy", "stress"):
        assert torch.equal(getattr(second.system, k),
                           getattr(whole.system, k)), k
    # with the barostat's initial state in place of the saved one the
    # run ends elsewhere
    fresh = make()
    saved["hook_states"] = fresh.state_dict()["hook_states"]
    third = make()
    third.restart_simulation(saved)
    third.simulate(10, chunk_size=5)
    assert not torch.equal(third.system.cells, whole.system.cells)


def test_npt_refuses_a_fixed_cell_calculator():
    from schnetpack_tpu_torch.atomistic import Atomwise, Forces
    from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
    from schnetpack_tpu_torch.model import NeuralNetworkPotential
    from schnetpack_tpu_torch.representation import PaiNN

    pot = NeuralNetworkPotential(PaiNN(n_atom_basis=32, n_interactions=1,
                                       cutoff=5.0),
                                 [Atomwise(n_in=32), Forces()])
    calc = SchNetPackCalculator(pot, cutoff=5.0, neighbor_list="cellblock")
    _, s = systems(argon_fcc())
    b = hooks.NHCBarostatIsotropic(**BARO)
    with pytest.raises(ValueError, match="computes no stress"):
        Simulator(s, NPTVelocityVerlet(DT, b), calc, simulator_hooks=[b])
    with pytest.raises(ValueError, match="barostat must be among"):
        Simulator(s, NPTVelocityVerlet(DT, b), lj(LJCalculator))
