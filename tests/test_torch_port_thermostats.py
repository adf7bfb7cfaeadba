"""PyTorch port, thermostatted MD on the CPU against the JAX package, in
float64, on the 8-atom Lennard-Jones argon cluster of ``tests/test_md.py``
(whose LJ calculator is both packages' cheap potential):

* 200-step trajectories with Berendsen and NHC (chain 3, per molecule and
  massive) against the JAX ``Simulator``;
* one application of Langevin and GLE: the port's deterministic update
  (``kick``) gets the noise that ``jax.random.normal`` draws from the key
  that JAX's ``apply`` receives;
* ``load_gle_matrices`` on the same files;
* Langevin and NHC equilibrate the cluster to the bath (the bounds of
  ``tests/test_md.py``);
* a checkpoint: 40 steps equal 20 steps, a ``Checkpoint``, a restart into
  a fresh simulator and 20 more, bit for bit (the generator's state and
  the hook states are restored);
* the system's derived quantities against the JAX ``System``.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.md import RingPolymer as JRingPolymer
from schnetpack_tpu.md import Simulator as JSimulator
from schnetpack_tpu.md import VelocityVerlet as JVelocityVerlet
from schnetpack_tpu.md import load_molecules as jload_molecules
from schnetpack_tpu.md import simulation_hooks as jhooks
from schnetpack_tpu.md.calculators import LJCalculator as JLJCalculator
from schnetpack_tpu.md.utils.thermostat_utils import (
    load_gle_matrices as jload_gle_matrices,
)
from schnetpack_tpu_torch.md import (
    RingPolymer, Simulator, VelocityVerlet, load_molecules,
)
from schnetpack_tpu_torch.md import simulation_hooks as hooks
from schnetpack_tpu_torch.md.calculators import LJCalculator
from schnetpack_tpu_torch.md.utils import load_gle_matrices
from schnetpack_tpu_torch.units import md_units

# argon LJ parameters (eV, Angstrom), as tests/test_md.py
EPS, R_EQ, LJ_CUTOFF = 0.0103, 3.82, 8.0
DT = 0.5              # fs
N_STEPS = 200
# float64 trajectories: the two packages' sums and exps differ in the
# last bits, which 200 steps of an 8-atom cluster amplify to ~1e-13
TRAJ_ATOL = 1e-10
# one thermostat application in float64
KICK_ATOL = 1e-12
# NHC's extended energy over 200 steps, as a share of the energy its
# chains exchanged: the splitting's O(dt^2) wobble, 5e-7 (per molecule)
# and 7e-8 (massive) here
NHC_EXTENDED_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread_x64():
    torch.set_num_threads(1)
    with jax.enable_x64(True):
        yield


def argon_cluster():
    """``tests/test_md.py::argon_cluster``: a loose 2x2x2 cube."""
    rng = np.random.RandomState(0)
    grid = np.array([[i, j, k] for i in range(2) for j in range(2)
                     for k in range(2)], float)
    return {P.Z: np.full(8, 18), P.R: grid * 3.9 + rng.rand(8, 3) * 0.05,
            P.cell: np.zeros((3, 3)), P.pbc: np.zeros(3, bool)}


def start_state(n_replicas=1, temperature=40.0, seed=1, spread=0.0):
    """(positions [R, 8, 3] or None, momenta [R, 8, 3]) in MD units:
    Maxwell-Boltzmann momenta without net momentum per replica, and beads
    displaced by ``spread`` Angstrom (None: the cluster's own positions)."""
    rng = np.random.RandomState(seed)
    mol = argon_cluster()
    masses = 39.948 * md_units().mass
    sigma = np.sqrt(masses * md_units().kB * temperature)
    p = sigma * rng.randn(n_replicas, 8, 3)
    p -= p.mean(axis=1, keepdims=True)
    R = None
    if spread:
        conv = md_units().length
        R = (mol[P.R][None] + spread * rng.randn(n_replicas, 8, 3)) * conv
    return R, p


def jax_system(n_replicas=1, R=None, p=None):
    s = jload_molecules([argon_cluster()], n_replicas=n_replicas,
                        dtype=jnp.float64)
    upd = {}
    if R is not None:
        upd["positions"] = jnp.asarray(R)
    if p is not None:
        upd["momenta"] = jnp.asarray(p)
    return s.replace(**upd)


def port_system(n_replicas=1, R=None, p=None):
    s = load_molecules([argon_cluster()], n_replicas=n_replicas,
                       dtype=torch.float64, device="cpu")
    upd = {}
    if R is not None:
        upd["positions"] = torch.tensor(R)
    if p is not None:
        upd["momenta"] = torch.tensor(p)
    return s.replace(**upd)


def jax_lj():
    return JLJCalculator(r_equilibrium=R_EQ, well_depth=EPS,
                         cutoff=LJ_CUTOFF)


def port_lj():
    return LJCalculator(r_equilibrium=R_EQ, well_depth=EPS, cutoff=LJ_CUTOFF)


def jax_trajectory(make_hooks, n_replicas=1, R=None, p=None, steps=N_STEPS,
                   integrator=None):
    sim = JSimulator(jax_system(n_replicas, R, p),
                     integrator or JVelocityVerlet(DT), jax_lj(),
                     simulator_hooks=make_hooks(), progress=False,
                     log_keys=("energy",))
    sim.simulate(steps, chunk_size=steps)
    s = sim.state.system
    return (np.asarray(s.positions), np.asarray(s.momenta),
            np.asarray(s.energy))


def port_trajectory(make_hooks, n_replicas=1, R=None, p=None, steps=N_STEPS,
                    integrator=None, chunk_size=N_STEPS // 2):
    sim = Simulator(port_system(n_replicas, R, p),
                    integrator or VelocityVerlet(DT), port_lj(),
                    simulator_hooks=make_hooks(), log_keys=("energy",))
    sim.simulate(steps, chunk_size=chunk_size)
    s = sim.system
    return s.positions.numpy(), s.momenta.numpy(), s.energy.numpy()


def assert_trajectories_match(port, jax_):
    for got, want in zip(port, jax_):
        np.testing.assert_allclose(got, want, rtol=0, atol=TRAJ_ATOL)


# ------------------------------------------------------------ trajectories
NVT_HOOKS = {
    "berendsen": (lambda m: m.BerendsenThermostat(60.0, time_constant=20.0)),
    "nhc": (lambda m: m.NHCThermostat(60.0, time_constant=20.0,
                                      chain_length=3)),
    "nhc_massive": (lambda m: m.NHCThermostat(60.0, time_constant=20.0,
                                              chain_length=3, massive=True)),
}


@pytest.mark.parametrize("name", list(NVT_HOOKS))
def test_nvt_trajectory_matches_jax(name):
    _, p0 = start_state()
    make = NVT_HOOKS[name]
    want = jax_trajectory(lambda: [make(jhooks)], p=p0)
    got = port_trajectory(lambda: [make(hooks)], p=p0)
    assert_trajectories_match(got, want)
    # the thermostat acted: an NVE run ends elsewhere
    nve = port_trajectory(lambda: [], p=p0)
    assert np.abs(nve[1] - got[1]).max() > 1e-3


@pytest.mark.parametrize("massive", [False, True])
def test_nhc_extended_energy_is_conserved(massive):
    """The cluster's kinetic and potential energy plus the chains'
    ``chain_energy`` stays constant along an NHC trajectory, to a small
    share of the energy that the chains exchanged with the cluster: a
    chain whose heat did not balance its scaling of the momenta would
    drift by about that much."""
    _, p0 = start_state()
    nhc = hooks.NHCThermostat(60.0, time_constant=20.0, massive=massive)
    sim = Simulator(port_system(p=p0), VelocityVerlet(DT), port_lj(),
                    simulator_hooks=[nhc])
    E, H = [], []
    for _ in range(21):
        sim.simulate(10 if E else 0, chunk_size=10)
        s = sim.system
        E.append(float(s.kinetic_energy.sum() + s.energy.sum()))
        H.append(E[-1] + float(nhc.chain_energy(sim.hook_states[0], s)))
    exchanged = np.ptp(E)
    assert exchanged > 1e-3, exchanged          # MD units: ~0.1 eV
    assert np.ptp(H) <= NHC_EXTENDED_RTOL * exchanged, (np.ptp(H), exchanged)


def test_lj_energy_forces_stress_match_jax():
    R, p = start_state(n_replicas=2, spread=0.05)
    jcalc = JLJCalculator(r_equilibrium=R_EQ, well_depth=EPS,
                          cutoff=LJ_CUTOFF, calc_stress=True)
    calc = LJCalculator(r_equilibrium=R_EQ, well_depth=EPS, cutoff=LJ_CUTOFF,
                        calc_stress=True)
    js = jcalc.calculate(jax_system(2, R, p))
    s = calc.calculate(port_system(2, R, p))
    for k in ("energy", "forces", "stress"):
        np.testing.assert_allclose(getattr(s, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    assert np.abs(s.forces.numpy()).max() > 1.0


def test_system_quantities_match_jax():
    R, p = start_state(n_replicas=3, spread=0.05)
    mol = argon_cluster()
    L = 12.0 * md_units().length
    cell = np.diag([L, 1.1 * L, 0.9 * L])
    stress = np.random.RandomState(5).randn(3, 1, 3, 3)
    js = jax_system(3, R, p).replace(
        cells=jnp.broadcast_to(jnp.asarray(cell), (3, 1, 3, 3)),
        pbc=jnp.asarray([[True, True, False]]), stress=jnp.asarray(stress))
    s = port_system(3, R, p).replace(
        cells=torch.tensor(cell).expand(3, 1, 3, 3).clone(),
        pbc=torch.tensor([[True, True, False]]), stress=torch.tensor(stress))
    # shift some atoms out of the cell so that wrapping moves them
    shift = np.zeros((3, 8, 3))
    shift[:, :3] = -0.7 * L
    js = js.replace(positions=js.positions + shift)
    s = s.replace(positions=s.positions + torch.tensor(shift))
    for k in ("kinetic_energy_tensor", "kinetic_energy", "degrees_of_freedom",
              "temperature", "centroid_positions", "centroid_momenta",
              "centroid_kinetic_energy", "centroid_temperature", "volume",
              "pressure"):
        np.testing.assert_allclose(getattr(s, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-12,
                                   atol=1e-14, err_msg=k)
    np.testing.assert_allclose(s.wrap_positions().positions.numpy(),
                               np.asarray(js.wrap_positions().positions),
                               rtol=0, atol=1e-12)
    assert not np.allclose(s.wrap_positions().positions.numpy(),
                           s.positions.numpy())
    assert tuple(load_molecules([mol], n_replicas=2, device="cpu")
                 .stress.shape) == (2, 1, 3, 3)


# --------------------------------------------------- one stochastic update
def gle_file(tmp_path, with_c=True):
    """A three-dimensional GLE (one auxiliary pair... two auxiliary
    momenta) in i-PI's format: A in fs^-1, C in K."""
    lines = ["# GLE parameters", "# A MATRIX (femtoseconds^-1):",
             "#  2.0e-3  1.0e-3 -5.0e-4",
             "# -1.0e-3  8.0e-3  0.0",
             "#  5.0e-4  0.0     2.0e-2"]
    if with_c:
        lines += ["# C MATRIX (K):", "#  50.0  4.0  0.0",
                  "#  4.0  70.0  3.0", "#  0.0  3.0  90.0"]
    f = tmp_path / ("gle_c.txt" if with_c else "gle.txt")
    f.write_text("\n".join(lines) + "\n")
    return str(f)


def piglet_file(tmp_path, temps_K, gamma_fs=0.2):
    """``tests/test_rpmd_thermostats.py::piglet_file``: one (A, C) section
    per normal mode, s = 1, per-mode target temperatures."""
    lines = ["# PIGLET parameters", "# A MATRIX (femtoseconds^-1):"]
    for k, _ in enumerate(temps_K):
        lines.append(f"# Matrix for normal mode {k}")
        lines.append(f"  {gamma_fs * (1 + 0.5 * k)}")
    lines.append("# C MATRIX (K):")
    for k, T in enumerate(temps_K):
        lines.append(f"# Matrix for normal mode {k}")
        lines.append(f"  {T}")
    f = tmp_path / "piglet.txt"
    f.write_text("\n".join(lines) + "\n")
    return str(f)


def dt_md():
    from schnetpack_tpu_torch.units import _parse_unit

    return DT * _parse_unit("fs") * md_units().time


def one_kick(jhook, hook, n_replicas, draw, kick, seed=7):
    """Apply ``jhook`` once (JAX) and ``kick`` the port's ``hook`` with
    the noise ``draw(key, jstate, jsystem)`` that JAX's apply drew; return
    both (state, system) pairs."""
    R, p = start_state(n_replicas, spread=0.05 if n_replicas > 1 else 0.0)
    js, s = jax_system(n_replicas, R, p), port_system(n_replicas, R, p)
    dt = dt_md()
    jst, st = jhook.init_state(js, dt), hook.init_state(s, dt)
    key = jax.random.PRNGKey(seed)
    jst, js = jhook.apply(jst, js, key, dt)
    noise = [torch.tensor(np.asarray(x)) for x in draw(key, jst, js)]
    return (jst, js), kick(hook, st, s, noise, dt)


def normal(key, shape):
    return jax.random.normal(key, shape, jnp.float64)


def test_langevin_kick_matches_jax():
    (_, js), s = one_kick(
        jhooks.LangevinThermostat(40.0, time_constant=20.0),
        hooks.LangevinThermostat(40.0, time_constant=20.0), 2,
        lambda key, st, sy: [normal(key, sy.momenta.shape)],
        lambda h, st, sy, xi, dt: h.kick(sy, xi[0], dt))
    np.testing.assert_allclose(s.momenta.numpy(), np.asarray(js.momenta),
                               rtol=0, atol=KICK_ATOL)


@pytest.mark.parametrize("with_c", [True, False])
def test_gle_kick_matches_jax(tmp_path, with_c):
    path = gle_file(tmp_path, with_c)
    (jst, js), (st, s) = one_kick(
        jhooks.GLEThermostat(40.0, path), hooks.GLEThermostat(40.0, path), 2,
        lambda key, st, sy: [normal(key, sy.momenta.shape
                                    + (st["s"].shape[-1] + 1,))],
        lambda h, st, sy, xi, dt: h.kick(st, sy, xi[0]))
    np.testing.assert_allclose(s.momenta.numpy(), np.asarray(js.momenta),
                               rtol=0, atol=KICK_ATOL)
    np.testing.assert_allclose(st["s"].numpy(), np.asarray(jst["s"]),
                               rtol=0, atol=KICK_ATOL)
    assert np.abs(st["s"].numpy()).max() > 0.0


def test_load_gle_matrices_match_jax(tmp_path):
    for path in (gle_file(tmp_path, True), gle_file(tmp_path, False),
                 piglet_file(tmp_path, [20.0, 160.0, 160.0, 160.0])):
        a, c = load_gle_matrices(path)
        ja, jc = jload_gle_matrices(path)
        np.testing.assert_allclose(a, ja, rtol=1e-15)
        if jc is None:
            assert c is None
        else:
            np.testing.assert_allclose(c, jc, rtol=1e-15)
    with pytest.raises(ValueError, match="PIGLET"):
        hooks.GLEThermostat(40.0, piglet_file(tmp_path, [20.0, 160.0]))


# ----------------------------------------------------------- statistics
def equilibrated_temperature(hook, T0, seed=3):
    """Mean temperature of steps 200-500 after 1,500 steps of the cluster
    under ``hook`` (``tests/test_md.py``'s protocol)."""
    _, p = start_state(temperature=T0, seed=seed)
    sim = Simulator(port_system(p=p), VelocityVerlet(DT), port_lj(),
                    simulator_hooks=[hook], seed=seed)
    sim.simulate(1500, chunk_size=500)
    sim.simulate(500, chunk_size=500)
    return float(np.mean(sim.logs[-1]["temperature"][200:]))


@pytest.mark.parametrize("name", ["langevin", "nhc"])
def test_thermostat_equilibrates_to_bath(name):
    target = 40.0
    if name == "langevin":
        T = equilibrated_temperature(
            hooks.LangevinThermostat(target, time_constant=20.0), 10.0)
    else:
        T = equilibrated_temperature(
            hooks.NHCThermostat(target, time_constant=25.0), 25.0)
    assert 0.5 * target < T < 1.6 * target, T


# ----------------------------------------------------------- checkpoints
def test_checkpoint_restart_is_bitwise(tmp_path):
    """40 steps in one run equal 20 steps, a checkpoint, a restart into a
    fresh simulator and 20 more, bit for bit: the Langevin noise after the
    restart continues the generator's stream, and the COM hook's counter
    (its state) continues too."""
    _, p = start_state(temperature=30.0)

    def make(extra=()):
        return Simulator(port_system(p=p), VelocityVerlet(DT), port_lj(),
                         simulator_hooks=[
                             hooks.LangevinThermostat(40.0, 20.0),
                             hooks.RemoveCOMMotion(every_n_steps=7),
                             *extra], seed=11)

    whole = make()
    whole.simulate(40, chunk_size=10)
    path = str(tmp_path / "ckpt" / "state.pkl")
    first = make([hooks.Checkpoint(path, every_n_steps=20)])
    first.simulate(20, chunk_size=10)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    assert saved["n_simulated"] == 20 and saved["hook_states"][1] == 40
    second = make()
    second.restart_simulation(saved)
    second.simulate(20, chunk_size=10)
    assert second.n_simulated == 40
    for k in ("positions", "momenta", "forces", "energy"):
        assert torch.equal(getattr(second.system, k),
                           getattr(whole.system, k)), k
    # a restart without the generator's state would draw other noise
    third = make()
    saved["generator"] = torch.Generator().manual_seed(99).get_state().numpy()
    third.restart_simulation(saved)
    third.simulate(20, chunk_size=10)
    assert not torch.equal(third.system.momenta, whole.system.momenta)


def test_soft_restart_keeps_hook_states():
    _, p = start_state()
    sim = Simulator(port_system(p=p), VelocityVerlet(DT), port_lj(),
                    simulator_hooks=[hooks.NHCThermostat(40.0, 20.0)])
    sim.simulate(10, chunk_size=10)
    saved = sim.state_dict()
    sim.simulate(10, chunk_size=10)
    kept = sim.hook_states[0]["p_xi"].clone()
    sim.load_state_dict(saved, soft=True)
    assert torch.equal(sim.hook_states[0]["p_xi"], kept)
    sim.load_state_dict(saved)
    assert torch.equal(sim.hook_states[0]["p_xi"],
                       torch.tensor(saved["hook_states"][0]["p_xi"]))
    assert sim.n_simulated == 10


def test_device_hooks_run_in_order_and_reverse():
    """Each step applies the device hooks in order before the first half
    step and in reverse after the last; host hooks get numpy chunks."""
    calls = []

    class Tag(hooks.DeviceHook):
        def __init__(self, name):
            self.name = name

        def apply(self, state, system, generator, dt):
            assert isinstance(generator, torch.Generator)
            calls.append(self.name)
            return state + 1, system

    class Host(hooks.SimulationHook):
        def process_chunk(self, simulator, logs, start_step):
            calls.append((start_step, logs["energy"].shape,
                          type(logs["energy"])))

    sim = Simulator(port_system(), VelocityVerlet(DT), port_lj(),
                    simulator_hooks=[Tag("a"), Host(), Tag("b")])
    sim.simulate(2, chunk_size=1)
    assert calls == ["a", "b", "b", "a", (0, (1, 1, 1), np.ndarray),
                     "a", "b", "b", "a", (1, (1, 1, 1), np.ndarray)]
    assert sim.hook_states == [4, 4]


def test_ring_polymer_integrator_matches_jax_free_particle():
    """One ``main_step`` of ``RingPolymer`` on random beads (the exact
    free-ring-polymer propagation) against JAX's."""
    R, p = start_state(n_replicas=4, spread=0.1)
    jint, integ = JRingPolymer(DT, 4, 40.0), RingPolymer(DT, 4, 40.0)
    js = jint.main_step(jax_system(4, R, p))
    s = integ.main_step(port_system(4, R, p))
    np.testing.assert_allclose(s.positions.numpy(), np.asarray(js.positions),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(s.momenta.numpy(), np.asarray(js.momenta),
                               rtol=0, atol=1e-12)
