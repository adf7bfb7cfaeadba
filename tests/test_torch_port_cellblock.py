"""PyTorch port, the 27-cell atom layout (``neighbor_list="cellblock_atom"``):
the host layout against the JAX layout array for array, the twins of the
row-13 gather (K16/K17) and the row-14 message (K18/K19) against
``jax.vjp`` of the JAX package's XLA oracles, PaiNN-128x3 with the bench
asset on the cell path, a small PaiNN through both packages' calculators
and a 20-step NVE trajectory.  The CUDA kernels are held against the twins
in ``test_torch_port_kernels.py``.

Inputs are made with numpy from fixed seeds and handed to both packages;
the JAX package runs its XLA path (``IMPL="xla"``) on the CPU.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.atomistic import Atomwise as JAtomwise
from schnetpack_tpu.atomistic import Forces as JForces
from schnetpack_tpu.atomistic import PairwiseDistances as JPairwiseDistances
from schnetpack_tpu.data.loader import PaddingSpec, collate
from schnetpack_tpu.md import Simulator as JSimulator
from schnetpack_tpu.md import VelocityVerlet as JVelocityVerlet
from schnetpack_tpu.md import load_molecules as jload_molecules
from schnetpack_tpu.md.calculators import SchNetPackCalculator as JCalculator
from schnetpack_tpu.md.neighborlist_md import (
    CellBlockNeighborListMD as JCellBlockNBL,
)
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.ops import cellblock as jcellblock
from schnetpack_tpu.ops import painn_fused as jpainn_fused
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu.transform.neighborlist import NeighborListTransform
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic import Atomwise, Forces, PairwiseDistances
from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
from schnetpack_tpu_torch.md import (
    CellBlockNeighborListMD, Simulator, VelocityVerlet, load_molecules,
)
from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.ops import cellblock_gather as cg
from schnetpack_tpu_torch.ops import painn_fused as pf
from schnetpack_tpu_torch.ops.cellblock import (
    OFFSETS, CapacityError, build_cell_layout,
)
from schnetpack_tpu_torch.representation import PaiNN
from schnetpack_tpu_torch.units import _parse_unit, md_units
from torch_port_cases import MSG_ATOL, MSG_RTOL, cell_case, random_box
from test_torch_port_model import (
    ASSET, CUTOFF, E_RTOL, F_ATOL, fcc_box, jax_energy_forces,
    port_potential,
)

# one-hot selection (XLA, exact in f32) against a row read: the forward
# is exact; the VJP sums up to ~30 unit-size terms in another order
GATHER_RTOL, GATHER_ATOL = 1e-6, 1e-6
GATHER_VJP_RTOL, GATHER_VJP_ATOL = 1e-5, 1e-5
# a small PaiNN through two calculators: f32 sums in another order
SMALL_E_RTOL, SMALL_E_ATOL = 1e-5, 1e-6
SMALL_F_RTOL, SMALL_F_ATOL = 1e-4, 1e-5
# 20 NVE steps: the f32 force differences integrate to far below these
POS_ATOL = 1e-5      # nm
MOM_RTOL, MOM_ATOL = 1e-4, 1e-4
SMALL_CUTOFF, SMALL_SHELL = 3.0, 0.4
LAYOUT_FIELDS = ("order", "rank", "slot_mask", "qidx", "nbh_idx", "nbh_mask",
                 "nbh_offsets")


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jcellblock, "IMPL", "xla")


def _boxes():
    """(R, cutoff, cell, pbc) of the layout cases: a 90-atom periodic box
    with an aliased 2-cell grid, the 256-atom FCC box (3 cells per axis)
    and a non-periodic cluster."""
    R, cell = random_box(90, 9.0, seed=11)
    fcc, fcc_cell = fcc_box(4)
    cluster = np.random.RandomState(3).uniform(0, 8.0, size=(40, 3))
    return {
        "aliased": (R, 3.4, cell, np.ones(3, bool)),
        "fcc": (fcc, 5.6, fcc_cell, np.ones(3, bool)),
        "cluster": (cluster, 2.5, None, None),
    }


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("box", ["aliased", "fcc", "cluster"])
def test_cell_layout_matches_jax(box):
    R, rc, cell, pbc = _boxes()[box]
    want = jcellblock.build_cell_layout(R, rc, cell, pbc)
    got = build_cell_layout(R, rc, cell, pbc)
    assert got.dims == want.dims
    for name in LAYOUT_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    nx, ny, nz = got.dims[:3]
    if box == "aliased":
        assert max(nx, ny, nz) <= 2
    elif box == "fcc":
        assert (nx, ny, nz) == (3, 3, 3)


def test_cell_layout_pins_raise_as_in_jax():
    R, rc, cell, pbc = _boxes()["aliased"]
    lay = build_cell_layout(R, rc, cell, pbc)
    nx, ny, nz, C, K = lay.dims
    pinned = build_cell_layout(R, rc, cell, pbc, capacity=C + 8,
                               n_neighbors=K + 4, dims=(nx, ny, nz))
    want = jcellblock.build_cell_layout(R, rc, cell, pbc, capacity=C + 8,
                                        n_neighbors=K + 4, dims=(nx, ny, nz))
    assert pinned.dims == want.dims == (nx, ny, nz, C + 8, K + 4)
    np.testing.assert_array_equal(pinned.qidx, want.qidx)
    occupancy = int(lay.slot_mask.reshape(-1, C).sum(1).max())
    for build, capacity_error in [
            (build_cell_layout, CapacityError),
            (jcellblock.build_cell_layout, jcellblock.CapacityError)]:
        with pytest.raises(capacity_error):
            build(R, rc, cell, pbc, capacity=occupancy - 1)
        # a degree above the pinned K is a plain ValueError in the
        # reference, which the MD neighbor list does not catch
        with pytest.raises(ValueError, match="n_neighbors") as err:
            build(R, rc, cell, pbc, n_neighbors=int(lay.nbh_mask.sum(1).max()) - 1)
        assert not isinstance(err.value, capacity_error)


@pytest.mark.parametrize("box", ["aliased", "fcc", "cluster"])
def test_decoded_source_rows_are_nbh_idx(box):
    """The twins decode qidx themselves: the source row of every real slot
    is the layout's nbh_idx, and the source-sorted schedule lists each
    real slot once, grouped by that row, with its counts and row pointers
    (int32, ``colblock.sorted_runs``)."""
    R, rc, cell, pbc = _boxes()[box]
    lay = build_cell_layout(R, rc, cell, pbc)
    refs = cg.CellRefs(torch.tensor(lay.qidx))
    j, valid = cg.decode_cell_j(refs)
    np.testing.assert_array_equal(valid.numpy(), lay.nbh_mask > 0)
    np.testing.assert_array_equal(j.numpy()[lay.nbh_mask > 0],
                                  lay.nbh_idx[lay.nbh_mask > 0])
    esorted, cnt, rowptr = cg.source_order(refs)
    assert esorted.dtype == cnt.dtype == rowptr.dtype == torch.int32
    assert torch.equal(cnt, rowptr.diff())
    n = int(valid.sum())
    assert int(rowptr[-1]) == n
    slots = esorted[:n].long()
    assert torch.equal(torch.sort(slots).values,
                       torch.nonzero(valid.reshape(-1))[:, 0])
    rows = j.reshape(-1)[slots]
    counts = torch.bincount(rows, minlength=refs.n_rows)
    assert torch.equal(rowptr.diff().long(), counts)
    assert bool((rows.diff() >= 0).all())
    assert len(OFFSETS) == 27 and tuple(OFFSETS[13]) == (0, 0, 0)


# ------------------------------------------------------------------ row 13
@pytest.mark.parametrize("D", [3, 192])
def test_cell_gather_twins_match_jax_vjp(D):
    c = cell_case()
    rng = np.random.RandomState(D)
    Ap, K = c["lay"].nbh_idx.shape
    table = rng.randn(Ap, D).astype(np.float32)
    g = rng.randn(Ap, K, D).astype(np.float32)
    out, vjp = jax.vjp(lambda t: jcellblock.cell_gather(t, jnp.asarray(
        c["qidx"])), jnp.asarray(table))
    (dT,) = vjp(jnp.asarray(g))
    qidx = torch.tensor(c["qidx"])
    np.testing.assert_allclose(cg.cell_gather_plain(torch.tensor(table),
                                                    qidx).numpy(),
                               np.asarray(out), GATHER_RTOL, GATHER_ATOL)
    np.testing.assert_allclose(cg.cell_gather_bwd_plain(torch.tensor(g),
                                                        qidx).numpy(),
                               np.asarray(dT), GATHER_VJP_RTOL,
                               GATHER_VJP_ATOL)
    # the autograd op pairs them
    t = torch.tensor(table, requires_grad=True)
    (got,) = torch.autograd.grad(cg.cell_gather(t, qidx), t, torch.tensor(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(dT), GATHER_VJP_RTOL,
                               GATHER_VJP_ATOL)


# ------------------------------------------------------------------ row 14
@pytest.mark.parametrize("seed", [9, 4])
def test_cell_message_twins_match_jax_vjp(seed):
    c = cell_case(seed=seed)
    names = ("xmu", "rbf", "dir", "FW")
    qidx = jnp.asarray(c["qidx"])
    (dq, dmu), vjp = jax.vjp(
        lambda *a: jpainn_fused._message_xla(*a, qidx),
        *[jnp.asarray(c[k]) for k in names])
    want = vjp((jnp.asarray(c["g_dq"]), jnp.asarray(c["g_dmu"])))
    t = [torch.tensor(c[k]) for k in names]
    refs = cg.CellRefs(torch.tensor(c["qidx"]))
    for got, w in zip(pf.cell_msg_fwd_plain(*t, refs), (dq, dmu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), MSG_RTOL,
                                   MSG_ATOL)
    got = pf.cell_msg_bwd_plain(*t, refs, torch.tensor(c["g_dq"]),
                                torch.tensor(c["g_dmu"]))
    for name, g, w in zip(("dxmu", "grbf", "gdir", "gFW"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), MSG_RTOL,
                                   MSG_ATOL, err_msg=name)
    # the autograd op returns the same cotangents (gFW only when FW_aug
    # requires grad)
    ins = [a.clone().requires_grad_(True) for a in t]
    out = pf.painn_message_cellblock(*ins, refs)
    grads = torch.autograd.grad(out, ins, (torch.tensor(c["g_dq"]),
                                           torch.tensor(c["g_dmu"])))
    for name, g, w in zip(names, grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), MSG_RTOL,
                                   MSG_ATOL, err_msg=name)


def test_cell_ops_refuse_other_devices_and_shapes():
    c = cell_case()
    refs = cg.CellRefs(torch.tensor(c["qidx"]))
    xmu = torch.tensor(c["xmu"])
    with pytest.raises(ValueError, match="device"):
        cg._on(xmu.to("meta"), None, None)
    with pytest.raises(ValueError, match="CUDA"):
        cg.cell_gather_fwd_kernel(xmu, refs)
    # F = 16 (F % 32 != 0) is taken by the general instance: a CPU tensor
    # is refused for its device, not its width
    with pytest.raises(ValueError, match="CUDA"):
        pf.cell_msg_fwd_kernel(xmu[:, :96].contiguous(),
                               torch.tensor(c["rbf"]),
                               torch.tensor(c["dir"]),
                               torch.tensor(c["FW"])[:, :48].contiguous(),
                               refs)


# ------------------------------------------------------------------- model
def _cell_inputs(R, cell, build_cutoff, pbc=None):
    """The 27-cell inputs of a box as the MD calculator passes them."""
    pbc = np.ones(3, bool) if pbc is None else pbc
    lay = build_cell_layout(R, build_cutoff, cell, pbc)
    Rs = (R[lay.order] * lay.slot_mask[:, None]).astype(np.float32)
    inputs = {
        TP.R: torch.tensor(Rs),
        TP.Z: torch.tensor(np.where(lay.slot_mask > 0, 18, 0)),
        TP.idx_m: torch.zeros(len(lay.order), dtype=torch.int64),
        TP.atom_mask: torch.tensor(lay.slot_mask),
        TP.n_atoms: torch.tensor([len(R)]),
        TP.cell_qidx: torch.tensor(lay.qidx),
        TP.nbh_idx: torch.tensor(lay.nbh_idx),
        TP.nbh_mask: torch.tensor(lay.nbh_mask),
        TP.nbh_offsets: torch.tensor(lay.nbh_offsets.astype(np.float32)),
    }
    return lay, inputs


def _cell_potential(params):
    pot = NeuralNetworkPotential(
        PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20, cutoff=CUTOFF),
        [Atomwise(n_in=128), Forces()], input_modules=[PairwiseDistances()])
    pot.load_state_dict(params)
    return pot.requires_grad_(False)


def test_painn_bench_asset_on_the_cell_path_matches_jax():
    """PaiNN-128x3 with the trained asset on the cell path of the jittered
    256-atom box against the JAX flat layout; the column path's parameters
    load unchanged."""
    rng = np.random.RandomState(0)
    R, cell = fcc_box(4)
    R = R + rng.uniform(-0.15, 0.15, R.shape)
    tree = load_jax_params(ASSET)
    E_ref, F_ref = jax_energy_forces(R, cell, tree)
    params = params_from_jax(tree)
    assert set(params) == set(port_potential().state_dict())

    lay, inputs = _cell_inputs(R, cell, CUTOFF + 0.6)
    assert lay.dims[:3] == (3, 3, 3)
    out = _cell_potential(params)(inputs)
    np.testing.assert_allclose(float(out[TP.energy][0]), E_ref, rtol=E_RTOL)
    F = out[TP.forces].numpy()
    assert np.abs(F[lay.slot_mask == 0]).max() == 0.0
    assert np.abs(F[lay.rank] - F_ref).max() <= F_ATOL


def test_cell_path_runs_its_twins_as_often_as_the_kernels_launch(
        monkeypatch):
    """One energy + forces evaluation on the cell path runs the gather's
    twins once each and the message's three times each, as the MD step on
    the card launches K16, K17 once and K18, K19 three times; the pad rows'
    displacements are exactly 0 and every gradient is finite."""
    counts = dict.fromkeys(["cell_gather", "cell_gather_bwd", "cell_msg_fwd",
                            "cell_msg_bwd"], 0)

    def counting(module, name):
        plain = getattr(module, f"{name}_plain")

        def counted(*args):
            counts[name] += 1
            return plain(*args)
        monkeypatch.setattr(module, f"{name}_plain", counted)

    counting(cg, "cell_gather")
    counting(cg, "cell_gather_bwd")
    counting(pf, "cell_msg_fwd")
    counting(pf, "cell_msg_bwd")
    R, cell = fcc_box(3)
    lay, inputs = _cell_inputs(R + 0.05, cell, CUTOFF + 0.6)
    pot = NeuralNetworkPotential(
        PaiNN(n_atom_basis=32, n_interactions=3, n_rbf=8, cutoff=CUTOFF,
              generator=torch.Generator().manual_seed(0)),
        [Atomwise(n_in=32), Forces()], input_modules=[PairwiseDistances()])
    x = dict(inputs)
    out = pot.requires_grad_(False)(x)
    assert torch.isfinite(out[TP.forces]).all()
    assert counts == {"cell_gather": 1, "cell_gather_bwd": 1,
                      "cell_msg_fwd": 3, "cell_msg_bwd": 3}
    rij = PairwiseDistances()(dict(inputs))[TP.nbh_rij]
    pad = torch.tensor(lay.nbh_mask) == 0
    assert bool(pad.any()) and float(rij[pad].abs().max()) == 0.0
    with pytest.raises(ValueError, match="PairwiseDistances"):
        pot.representation(dict(inputs))


# --------------------------------------------------------------- calculator
@functools.lru_cache(maxsize=1)
def _small_models():
    """A small PaiNN (F = 16, 2 interactions, 8 Gaussians, 3 A cutoff) in
    both packages with the JAX package's random initial weights (the model
    of ``tests/test_cellblock.py::TestMDParity``)."""
    pos, cell = random_box(90, 9.0, seed=11)
    mol = {P.Z: np.full(len(pos), 18, np.int64), P.R: pos, P.cell: cell,
           P.pbc: np.ones(3, bool)}
    jpot = JNNP(
        representation=JPaiNN(n_atom_basis=16, n_interactions=2, n_rbf=8,
                              cutoff=SMALL_CUTOFF),
        input_modules=[JPairwiseDistances()],
        output_modules=[JAtomwise(output_key=P.energy, n_out=1, n_layers=2),
                        JForces()])
    probe = NeighborListTransform(SMALL_CUTOFF)(dict(mol))
    params = jpot.init(jax.random.PRNGKey(0),
                       collate([probe], PaddingSpec(len(pos) + 8, 4096, 2)))
    params = jax.tree.map(np.asarray, params)
    pot = NeuralNetworkPotential(
        PaiNN(n_atom_basis=16, n_interactions=2, n_rbf=8,
              cutoff=SMALL_CUTOFF),
        [Atomwise(n_in=16, n_layers=2), Forces()],
        input_modules=[PairwiseDistances()])
    return mol, jpot, params, pot, params_from_jax(params)


def _calculate(calc, system):
    out = calc.calculate(system, calc.init_state(system))
    return np.asarray(out.forces[0]), np.asarray(out.energy)


def test_small_painn_calculators_match_on_cellblock_atom():
    """Both calculators with ``neighbor_list="cellblock_atom"`` on the
    90-atom box (an aliased 2-cell grid); then the port's forces against
    its own column and dense paths."""
    mol, jpot, jparams, pot, params = _small_models()
    jcalc = JCalculator(jpot, jparams, cutoff=SMALL_CUTOFF,
                        cutoff_shell=SMALL_SHELL,
                        neighbor_list="cellblock_atom")
    F_ref, E_ref = _calculate(jcalc, jload_molecules([mol]))
    system = load_molecules([mol], device="cpu")
    got = {}
    for mode in ("cellblock_atom", "cellblock"):
        calc = SchNetPackCalculator(pot, params, cutoff=SMALL_CUTOFF,
                                    cutoff_shell=SMALL_SHELL,
                                    neighbor_list=mode)
        assert calc.nbl.layout_kind == ("atom" if mode == "cellblock_atom"
                                        else "column")
        got[mode] = _calculate(calc, system)
    F, E = got["cellblock_atom"]
    np.testing.assert_allclose(E, E_ref, SMALL_E_RTOL, SMALL_E_ATOL)
    np.testing.assert_allclose(F, F_ref, SMALL_F_RTOL, SMALL_F_ATOL)
    assert np.abs(F).max() > 1e-3   # forces worth comparing
    F_col, E_col = got["cellblock"]
    np.testing.assert_allclose(E_col, E, SMALL_E_RTOL, SMALL_E_ATOL)
    np.testing.assert_allclose(F_col, F, SMALL_F_RTOL, SMALL_F_ATOL)
    calc = SchNetPackCalculator(pot, params, cutoff=SMALL_CUTOFF,
                                cutoff_shell=SMALL_SHELL,
                                neighbor_list="dense")
    F_dense, E_dense = _calculate(calc, system)
    np.testing.assert_allclose(E_dense, E, SMALL_E_RTOL, SMALL_E_ATOL)
    np.testing.assert_allclose(F_dense, F, SMALL_F_RTOL, SMALL_F_ATOL)


def test_atom_layout_state_carries_one_refs_per_build():
    """The neighbor list makes a build's ``CellRefs`` once and the
    calculator passes it to every step, so the source rows are decoded
    once per build; a rebuild brings new refs."""
    mol, _, _, pot, params = _small_models()
    calc = SchNetPackCalculator(pot, params, cutoff=SMALL_CUTOFF,
                                cutoff_shell=SMALL_SHELL,
                                neighbor_list="cellblock_atom")
    system = load_molecules([mol], device="cpu")
    st = calc.init_state(system)
    refs = st[TP.cell_refs]
    assert refs.qidx is st[TP.cell_qidx]
    calc.calculate(system, st)
    decoded = refs.cache["j"]
    calc.calculate(system, st)
    assert calc.model_inputs(system, st)[TP.cell_refs] is refs
    assert refs.cache["j"] is decoded
    calc.nbl.build(system)
    assert calc.nbl.state()[TP.cell_refs] is not refs


def test_atom_layout_refuses_replicas_and_molecules_as_jax():
    """More than one replica or molecule: the reference's errors, from the
    neighbor list and so from the calculator's ``init_state``."""
    _, jpot, jparams, pot, params = _small_models()
    rng = np.random.RandomState(5)
    mols = [{P.Z: np.full(8, 18, np.int64), P.R: rng.uniform(0, 4, (8, 3))}
            for _ in range(2)]
    for kw in [dict(molecules=mols[:1], n_replicas=2),
               dict(molecules=mols, n_replicas=1)]:
        jcalc = JCalculator(jpot, jparams, cutoff=SMALL_CUTOFF,
                            neighbor_list="cellblock_atom")
        with pytest.raises(NotImplementedError) as want:
            jcalc.init_state(jload_molecules(kw["molecules"],
                                             n_replicas=kw["n_replicas"]))
        calc = SchNetPackCalculator(pot, params, cutoff=SMALL_CUTOFF,
                                    neighbor_list="cellblock_atom")
        with pytest.raises(NotImplementedError) as got:
            calc.init_state(load_molecules(kw["molecules"],
                                           n_replicas=kw["n_replicas"],
                                           device="cpu"))
        assert str(got.value) == str(want.value)


def test_small_painn_nve_trajectory_matches_jax_on_cellblock_atom():
    """20 NVE steps of the small PaiNN on the 90-atom box, both packages on
    ``cellblock_atom`` from the same positions and momenta; a small skin
    makes the neighbor lists rebuild on the host mid-run."""
    mol, jpot, jparams, pot, params = _small_models()
    rng = np.random.RandomState(3)
    sigma = np.sqrt(39.948 * md_units().mass * md_units().kB * 100.0)
    p0 = (sigma * rng.randn(1, len(mol[P.R]), 3)).astype(np.float32)
    p0 -= p0.mean(axis=1, keepdims=True)
    conv = _parse_unit("Ang") * md_units().length
    skin = 0.03

    jnbl = JCellBlockNBL(SMALL_CUTOFF * conv, skin=skin * conv, layout="atom")
    jcalc = JCalculator(jpot, jparams, cutoff=SMALL_CUTOFF,
                        cutoff_shell=skin, neighbor_list=jnbl)
    jsim = JSimulator(jload_molecules([mol]).replace(momenta=jnp.asarray(p0)),
                      JVelocityVerlet(0.5), jcalc, progress=False,
                      log_keys=("energy", "temperature"))
    jsim.simulate(20, chunk_size=5)
    js = jsim.state.system

    nbl = CellBlockNeighborListMD(SMALL_CUTOFF * conv, skin=skin * conv,
                                  layout="atom")
    calc = SchNetPackCalculator(pot, params, cutoff=SMALL_CUTOFF,
                                cutoff_shell=skin, neighbor_list=nbl)
    system = load_molecules([mol], device="cpu").replace(
        momenta=torch.tensor(p0))
    sim = Simulator(system, VelocityVerlet(0.5), calc)
    sim.simulate(20, chunk_size=10)

    assert nbl.n_builds >= 2 and nbl.n_device_builds == 0
    np.testing.assert_allclose(sim.system.positions.numpy(),
                               np.asarray(js.positions), rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(sim.system.momenta.numpy(),
                               np.asarray(js.momenta), MOM_RTOL, MOM_ATOL)
    np.testing.assert_allclose(sim.system.energy.numpy(),
                               np.asarray(js.energy), SMALL_E_RTOL,
                               SMALL_E_ATOL)
