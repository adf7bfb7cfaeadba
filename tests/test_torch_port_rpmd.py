"""PyTorch port, ring-polymer MD on the CPU against the JAX package.

On the 8-atom Lennard-Jones argon cluster in float64
(``test_torch_port_thermostats.py``'s helpers): 200-step trajectories of
NVE ``RingPolymer`` and of ``NHCRingPolymerThermostat`` (local and
global) against the JAX ``Simulator``; one application each of PILE-L,
PILE-G, TRPMD, RPMD-GLE and PIGLET, the port's update fed the noise that
JAX's ``apply`` drew; PILE-L thermalising the free ring polymer's
centroid; the normal-mode round trip and the centroid momentum that
``RingPolymer`` conserves (``tests/test_md.py:115-139``).

On the column path: 4 beads of ``fcc_box(3)`` (108 atoms) with the
PaiNN-128x3 asset, 20 NVE ``RingPolymer`` steps with a small skin, so
that the device rebuild fires, against the JAX ``Simulator``, whose
calculator takes ``_calculate_blocked_replicas``; the union edge layout
against JAX's for the same beads; the blocked calculator against a
one-replica ``calculate`` per bead; and the message and mixing twins run
3 times per bead a step (the counts of K1-K4 on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.atomistic import Atomwise as JAtomwise
from schnetpack_tpu.atomistic import Forces as JForces
from schnetpack_tpu.atomistic import PairwiseDistances
from schnetpack_tpu.md import RingPolymer as JRingPolymer
from schnetpack_tpu.md import Simulator as JSimulator
from schnetpack_tpu.md import load_molecules as jload_molecules
from schnetpack_tpu.md import simulation_hooks as jhooks
from schnetpack_tpu.md.calculators import SchNetPackCalculator as JCalculator
from schnetpack_tpu.md.neighborlist_md import (
    CellBlockNeighborListMD as JCellBlockNBL,
)
from schnetpack_tpu.md.utils import NormalModeTransformer as JNormalModes
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
from schnetpack_tpu_torch.md import (
    CellBlockNeighborListMD, RingPolymer, Simulator, load_molecules,
)
from schnetpack_tpu_torch.md import simulation_hooks as hooks
from schnetpack_tpu_torch.md.calculators import (
    MDCalculator, SchNetPackCalculator,
)
from schnetpack_tpu_torch.md.utils import NormalModeTransformer
from schnetpack_tpu_torch.ops import colblock_message as msg
from schnetpack_tpu_torch.ops import painn_mixing as mix
from schnetpack_tpu_torch.units import _parse_unit, md_units

from test_torch_port_model import ASSET, CUTOFF, fcc_box, port_potential
from test_torch_port_thermostats import (
    DT, KICK_ATOL, assert_trajectories_match, jax_trajectory, normal,
    one_kick, piglet_file, gle_file, port_system, port_trajectory,
    start_state,
)

N_BEADS = 8
T_RP = 40.0          # K, the ring polymer's temperature


@pytest.fixture(autouse=True)
def _one_thread_x64():
    torch.set_num_threads(1)
    with jax.enable_x64(True):
        yield


def ring_start(seed=2):
    return start_state(n_replicas=N_BEADS, seed=seed, spread=0.03)


# ------------------------------------------------------------ trajectories
RP_HOOKS = {
    "nve": lambda m: [],
    "nhc_local": lambda m: [m.NHCRingPolymerThermostat(
        T_RP, time_constant=20.0, local=True)],
    "nhc_global": lambda m: [m.NHCRingPolymerThermostat(
        T_RP, time_constant=20.0, local=False)],
}


@pytest.mark.parametrize("name", list(RP_HOOKS))
def test_ring_polymer_trajectory_matches_jax(name):
    R, p = ring_start()
    make = RP_HOOKS[name]
    want = jax_trajectory(lambda: make(jhooks), N_BEADS, R, p,
                          integrator=JRingPolymer(DT, N_BEADS, T_RP))
    got = port_trajectory(lambda: make(hooks), N_BEADS, R, p,
                          integrator=RingPolymer(DT, N_BEADS, T_RP))
    assert_trajectories_match(got, want)
    if name != "nve":
        nve = port_trajectory(lambda: [], N_BEADS, R, p,
                              integrator=RingPolymer(DT, N_BEADS, T_RP))
        assert np.abs(nve[1] - got[1]).max() > 1e-3


# --------------------------------------------------- one stochastic update
def _pile_draw(key, st, sy):
    return [normal(key, sy.momenta.shape)]


def _pile_global_draw(key, st, sy):
    k_local, k_g, k_chi = jax.random.split(key, 3)
    dof = jnp.maximum(sy.degrees_of_freedom, 1.0)
    M = sy.n_molecules
    return [normal(k_local, sy.momenta.shape), normal(k_g, (M,)),
            jax.random.chisquare(k_chi, dof - 1.0, shape=(M,))]


@pytest.mark.parametrize("name", ["pile_local", "pile_global", "trpmd"])
def test_pile_kick_matches_jax(name):
    cls = {"pile_local": "PILELocalThermostat",
           "pile_global": "PILEGlobalThermostat",
           "trpmd": "TRPMDThermostat"}[name]
    kw = {} if name == "trpmd" else {"time_constant": 20.0}
    if name == "pile_global":
        draw = _pile_global_draw

        def kick(h, st, sy, noise, dt):
            return st, h.kick(st, sy, *noise, dt)
    else:
        draw = _pile_draw

        def kick(h, st, sy, noise, dt):
            return st, h.kick(st, sy, noise[0])
    (_, js), (_, s) = one_kick(getattr(jhooks, cls)(T_RP, **kw),
                               getattr(hooks, cls)(T_RP, **kw), N_BEADS,
                               draw, kick)
    np.testing.assert_allclose(s.momenta.numpy(), np.asarray(js.momenta),
                               rtol=0, atol=KICK_ATOL)


@pytest.mark.parametrize("name", ["rpmd_gle", "piglet"])
def test_rpmd_gle_kick_matches_jax(tmp_path, name):
    if name == "piglet":
        path = piglet_file(tmp_path, [20.0] + [160.0] * (N_BEADS - 1))
        jh, h = (jhooks.PIGLETThermostat(T_RP, path),
                 hooks.PIGLETThermostat(T_RP, path))
    else:
        path = gle_file(tmp_path, with_c=False)
        jh, h = (jhooks.RPMDGLEThermostat(T_RP, path),
                 hooks.RPMDGLEThermostat(T_RP, path))
    (jst, js), (st, s) = one_kick(
        jh, h, N_BEADS,
        lambda key, st, sy: [normal(key, sy.momenta.shape
                                    + (st["s"].shape[-1] + 1,))],
        lambda h, st, sy, xi, dt: h.kick(st, sy, xi[0]))
    np.testing.assert_allclose(s.momenta.numpy(), np.asarray(js.momenta),
                               rtol=0, atol=KICK_ATOL)
    np.testing.assert_allclose(st["s"].numpy(), np.asarray(jst["s"]),
                               rtol=0, atol=KICK_ATOL)


def test_piglet_refuses_other_bead_counts(tmp_path):
    path = piglet_file(tmp_path, [20.0, 160.0])
    with pytest.raises(ValueError, match="normal-mode"):
        hooks.PIGLETThermostat(T_RP, path).init_state(
            port_system(4), 0.5)
    with pytest.raises(ValueError, match="PIGLET"):
        hooks.RPMDGLEThermostat(T_RP, path).init_state(port_system(2), 0.5)


# ----------------------------------------------------------- statistics
class FreeCalculator(MDCalculator):
    """No potential: the free ring polymer."""

    def calculate(self, system, calc_state=None):
        return system.replace(forces=torch.zeros_like(system.positions),
                              energy=torch.zeros_like(system.energy))


def test_pile_local_thermalises_free_centroid():
    """PILE-L's centroid Langevin (tau 20 fs) brings the free ring
    polymer's centroid temperature to the bath: mean over 3 ps after a
    0.5 ps warm-up within 10% (the statistical error of the mean is ~3%:
    24 centroid degrees of freedom, ~150 independent samples)."""
    _, p = start_state(n_replicas=N_BEADS, temperature=5.0, seed=4)
    sim = Simulator(port_system(N_BEADS, p=p),
                    RingPolymer(1.0, N_BEADS, T_RP), FreeCalculator(),
                    simulator_hooks=[hooks.PILELocalThermostat(
                        T_RP, time_constant=20.0)],
                    seed=5, log_keys=("centroid_temperature",))
    sim.simulate(500, chunk_size=500)
    sim.simulate(3000, chunk_size=1000)
    T_c = np.concatenate([lg["centroid_temperature"][:, 0, 0]
                          for lg in sim.logs[1:]])
    assert abs(T_c.mean() - T_RP) < 0.1 * T_RP, T_c.mean()


def test_normal_mode_round_trip():
    x = np.random.RandomState(0).rand(16, 5, 3)
    nm = NormalModeTransformer(16)
    xt = torch.tensor(x)
    np.testing.assert_allclose(nm.normal2beads(nm.beads2normal(xt)).numpy(),
                               x, atol=1e-12)
    np.testing.assert_allclose(
        nm.beads2normal(xt).numpy(),
        np.asarray(JNormalModes(16).beads2normal(jnp.asarray(x))),
        rtol=0, atol=1e-14)


def test_ring_polymer_conserves_centroid_momentum():
    """``tests/test_md.py::test_ring_polymer_runs_and_conserves_centroid``
    on the port: 8 beads at 0.25 fs, 100 steps."""
    from test_torch_port_thermostats import port_lj

    _, p = start_state(n_replicas=N_BEADS, temperature=T_RP, seed=1)
    sim = Simulator(port_system(N_BEADS, p=p),
                    RingPolymer(0.25, N_BEADS, T_RP), port_lj())
    sim._ensure_state()
    p0 = sim.system.centroid_momenta.sum(1).numpy()
    sim.simulate(100, chunk_size=100)
    s = sim.system
    assert np.isfinite(s.positions.numpy()).all()
    np.testing.assert_allclose(s.centroid_momenta.sum(1).numpy(), p0,
                               atol=1e-8)
    assert s.positions.numpy().std(axis=0).mean() > 1e-5


# ------------------------------------------------------- the column path
N_COL_BEADS = 4
COL_STEPS = 20
SKIN = 0.04          # Angstrom: small, so the skin criterion fires
# K, the temperature of tests/test_md.py's ring polymer.  The springs turn
# a position difference dq into a momentum difference m w_k sin(w_k dt) dq
# a step (w_k up to 2 P kB T / hbar), so f32 roundoff of the positions
# reaches the momenta at a rate that grows as T^2: 4e-5 after 20 steps here
# (2e-4 at 100 K, over the tolerances below)
T_COL = 40.0
# as tests/test_torch_port_md.py: f32 forces integrated over 20 steps
POS_ATOL = 1e-5      # nm
MOM_RTOL, MOM_ATOL = 1e-4, 1e-4


def column_start():
    """fcc_box(3) jittered by +-0.1 A, beads displaced by 0.03 A rms each,
    Maxwell-Boltzmann momenta per bead at T_COL (f32, numpy)."""
    rng = np.random.RandomState(5)
    R, cell = fcc_box(3)
    R = R + rng.uniform(-0.1, 0.1, R.shape)
    mol = {P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
           P.pbc: np.ones(3, bool)}
    conv = _parse_unit("Ang") * md_units().length
    beads = ((R[None] + 0.03 * rng.randn(N_COL_BEADS, len(R), 3))
             * conv).astype(np.float32)
    sigma = np.sqrt(39.948 * md_units().mass * md_units().kB * T_COL)
    p0 = (sigma * rng.randn(N_COL_BEADS, len(R), 3)).astype(np.float32)
    p0 -= p0.mean(axis=1, keepdims=True)
    return mol, beads, p0


def jax_column_run(mol, beads, p0, params):
    conv = _parse_unit("Ang") * md_units().length
    system = jload_molecules([mol], n_replicas=N_COL_BEADS).replace(
        positions=jnp.asarray(beads), momenta=jnp.asarray(p0))
    pot = JNNP(representation=JPaiNN(n_atom_basis=128, n_interactions=3,
                                     n_rbf=20, cutoff=CUTOFF),
               input_modules=[PairwiseDistances()],
               output_modules=[JAtomwise(output_key=P.energy), JForces()])
    nbl = JCellBlockNBL(CUTOFF * conv, skin=SKIN * conv, layout="column")
    calc = JCalculator(pot, params, cutoff=CUTOFF, cutoff_shell=SKIN,
                       neighbor_list=nbl)
    sim = JSimulator(system, JRingPolymer(0.5, N_COL_BEADS, T_COL), calc,
                     progress=False, log_keys=("energy",))
    sim.state                                # the first build
    lay = nbl._layout
    first = {k: np.asarray(getattr(lay, k))
             for k in ("qcol", "dcol", "offcol", "order")}
    sim.simulate(COL_STEPS, chunk_size=COL_STEPS)
    s = sim.state.system
    return first, (np.asarray(s.positions), np.asarray(s.momenta),
                   np.asarray(s.energy))


def port_column_calculator(nbl):
    return SchNetPackCalculator(
        port_potential(fuse="full"), params_from_jax(load_jax_params(ASSET)),
        cutoff=CUTOFF, cutoff_shell=SKIN, neighbor_list=nbl)


@pytest.fixture(scope="module")
def column_case():
    mol, beads, p0 = column_start()
    with jax.enable_x64(False):
        first, traj = jax_column_run(mol, beads, p0, load_jax_params(ASSET))
    return mol, beads, p0, first, traj


def _count_twins(monkeypatch):
    """Count the message (K1/K2) and mixing (K3/K4) twins' forward calls
    and the backward passes through their outputs."""
    counts = {"msg_fwd": 0, "msg_bwd": 0, "mix_fwd": 0, "mix_bwd": 0}

    def counted(name, plain):
        def run(*args):
            out = plain(*args)
            counts[name + "_fwd"] += 1

            def bwd(g):
                counts[name + "_bwd"] += 1
            out[0].register_hook(bwd)
            return out
        return run

    monkeypatch.setattr(msg, "msg_fwd_plain",
                        counted("msg", msg.msg_fwd_plain))
    monkeypatch.setattr(mix, "painn_mixing_plain",
                        counted("mix", mix.painn_mixing_plain))
    return counts


def test_column_rpmd_matches_jax(column_case, monkeypatch):
    mol, beads, p0, first, (R_j, p_j, E_j) = column_case
    conv = _parse_unit("Ang") * md_units().length
    system = load_molecules([mol], n_replicas=N_COL_BEADS,
                            device="cpu").replace(
        positions=torch.tensor(beads), momenta=torch.tensor(p0))
    nbl = CellBlockNeighborListMD(CUTOFF * conv, skin=SKIN * conv)
    sim = Simulator(system, RingPolymer(0.5, N_COL_BEADS, T_COL),
                    port_column_calculator(nbl))
    sim._ensure_state()
    # the union layout of the beads, binned by their centroid, is JAX's
    for k, want in first.items():
        np.testing.assert_array_equal(getattr(nbl._layout, k), want,
                                      err_msg=k)
    counts = _count_twins(monkeypatch)
    sim.simulate(COL_STEPS, chunk_size=10)

    assert nbl.n_device_builds >= 1, "no rebuild went through the device"
    assert nbl.n_builds == 1 and nbl.n_device_overflows == 0
    assert counts == {k: 3 * N_COL_BEADS * COL_STEPS for k in counts}
    assert sim.logs[0]["energy"].shape == (10, N_COL_BEADS, 1)
    np.testing.assert_allclose(sim.system.positions.numpy(), R_j, rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(sim.system.momenta.numpy(), p_j,
                               rtol=MOM_RTOL, atol=MOM_ATOL)
    np.testing.assert_allclose(sim.system.energy.numpy(), E_j, rtol=1e-5)


def test_union_edges_cover_every_bead():
    """The layout's edges are the union of each bead's cell list: every
    bead's own edges are in it, and it is larger than any one bead's."""
    from schnetpack_tpu_torch.md.neighborlist_md import union_edges
    from schnetpack_tpu_torch.transform.neighborlist import (
        cell_list_neighbor_list,
    )

    mol, beads, _ = column_start()
    rc = (CUTOFF + SKIN) * _parse_unit("Ang") * md_units().length
    cell = mol[P.cell] * _parse_unit("Ang") * md_units().length
    B = beads.astype(np.float64)
    union = {tuple(r) for r in np.column_stack(union_edges(B, rc, cell,
                                                           np.ones(3, bool)))}
    sizes = []
    for r in range(N_COL_BEADS):
        own = {tuple(e) for e in np.column_stack(cell_list_neighbor_list(
            B[r], rc, cell, np.ones(3, bool)))}
        assert own <= union
        sizes.append(len(own))
    assert len(union) > max(sizes)


def test_blocked_calculator_matches_one_replica_per_bead():
    mol, beads, _ = column_start()
    conv = _parse_unit("Ang") * md_units().length
    system = load_molecules([mol], n_replicas=N_COL_BEADS,
                            device="cpu").replace(
        positions=torch.tensor(beads))
    calc = port_column_calculator(
        CellBlockNeighborListMD(CUTOFF * conv, skin=SKIN * conv))
    state = calc.init_state(system)
    blocked = calc.calculate(system, state)
    for r in range(N_COL_BEADS):
        one = calc.calculate(system.replace(
            positions=system.positions[r:r + 1],
            forces=system.forces[r:r + 1], energy=system.energy[r:r + 1]),
            state)
        assert torch.equal(blocked.forces[r], one.forces[0]), r
        assert torch.equal(blocked.energy[r], one.energy[0]), r
    assert not torch.equal(blocked.forces[0], blocked.forces[1])


def test_atom_layout_refuses_replicas():
    mol, beads, _ = column_start()
    system = load_molecules([mol], n_replicas=2, device="cpu")
    nbl = CellBlockNeighborListMD(0.5, skin=0.03, layout="atom")
    with pytest.raises(NotImplementedError, match="n_replicas == 1"):
        nbl.build(system)
