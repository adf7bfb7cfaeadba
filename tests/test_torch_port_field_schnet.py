"""PyTorch port, FieldSchNet column path: each of its modules (the field
interaction, the dipole update, the dipole-dipole interaction, the nuclear
magnetic moment embedding) against its flax counterpart, the whole
FieldSchNet-16x2 against the JAX package's column path with and without
fields, ``params_from_jax``, the gathers and folds a force evaluation
runs, a 20-step NVE trajectory against the JAX ``Simulator``, the trained
bench asset and the full-size fixture.  The CUDA kernels K11-K14 at the
model's widths are held against their twins in
``test_torch_port_kernels.py``.

Inputs are made with numpy from fixed seeds and handed to both packages;
the JAX package runs its XLA path (``IMPL="xla"``) on the CPU.  The
zero-initialised parameters (the dipole interaction's second filter
layer) are perturbed from a numpy seed, and each case checks that the
term it covers changes the energy.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.atomistic import Atomwise as JAtomwise
from schnetpack_tpu.atomistic import Forces as JForces
from schnetpack_tpu.atomistic import PairwiseDistances as JPairwiseDistances
from schnetpack_tpu.md import Simulator as JSimulator
from schnetpack_tpu.md import VelocityVerlet as JVelocityVerlet
from schnetpack_tpu.md import load_molecules as jload_molecules
from schnetpack_tpu.md.calculators import SchNetPackCalculator as JCalculator
from schnetpack_tpu.md.neighborlist_md import (
    CellBlockNeighborListMD as JCellBlockNBL,
)
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.ops import cellblock as jcellblock
from schnetpack_tpu.ops import colblock as jcb
from schnetpack_tpu.representation import FieldSchNet as JFieldSchNet
from schnetpack_tpu.representation import field_schnet as jfs
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic import Atomwise, Forces, PairwiseDistances
from schnetpack_tpu_torch.convert import _tree, load_jax_params, params_from_jax
from schnetpack_tpu_torch.md import (
    CellBlockNeighborListMD, Simulator, VelocityVerlet, load_molecules,
)
from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.ops import colblock_select as sel
from schnetpack_tpu_torch.ops.colblock import ColRefs
from schnetpack_tpu_torch.representation import FieldSchNet
from schnetpack_tpu_torch.representation import field_schnet as tfs
from schnetpack_tpu_torch.units import _parse_unit, md_units
from test_torch_port_model import ROOT, fcc_box, port_inputs
from test_torch_port_so3net import _box, _jax_column_inputs

ASSET = os.path.join(ROOT, "scripts", "assets",
                     "bench_field_schnet_argon.msgpack")
FIXTURE = os.path.join(ROOT, "tests", "data",
                       "port_ref_field_schnet_argon.npz")
CUTOFF = 5.0
EF, MF = P.electric_field, P.magnetic_field
# whole model: energy relative; forces elementwise
E_RTOL = 1e-5
F_RTOL, F_ATOL = 1e-4, 1e-5
# one module, its output and input cotangents: f32 sums in another order
MOD_RTOL, MOD_ATOL = 1e-4, 1e-5
# a term "changes the energy" when it moves it by more than ten times the
# energy's tolerance
TERM_RTOL = 10 * E_RTOL
# the NVE run: positions after 20 steps and the momenta
# (``test_torch_port_md.py``'s limits)
POS_ATOL = 1e-5      # nm
MOM_RTOL, MOM_ATOL = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jcellblock, "IMPL", "xla")


def _dipole_filter(name):
    """Whether ``name`` is a dipole interaction's zero-initialised second
    filter layer, ``filter_{field}_1`` (not SchNet's ``filter_1``)."""
    return (name.startswith("filter_") and name.endswith("_field_1"))


def _perturbed(tree, seed):
    """A copy of a flax param tree whose zero-initialised dipole filters
    (``dipole_inter_t/filter_{field}_1``) are seeded normal numbers."""
    rng = np.random.RandomState(seed)

    def walk(node, name=""):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v, k) for k, v in node.items()}
        if _dipole_filter(name):
            lin = out["linear"]
            out["linear"] = {k: rng.randn(*v.shape).astype(np.float32)
                             for k, v in lin.items()}
        return out
    return walk(jax.device_get(tree))


def _zero_dipole_filters(tree):
    """A copy of ``tree`` with every dipole filter's second layer zero."""
    def walk(node, name=""):
        if not isinstance(node, dict):
            return node
        if _dipole_filter(name):
            return {"linear": {k: np.zeros_like(v)
                               for k, v in node["linear"].items()}}
        return {k: walk(v, k) for k, v in node.items()}
    return walk(tree)


# ------------------------------------------------------------------ modules
def _edge_case(seed=0, F=8, B=6):
    """A small periodic box's column layout with its displacements, basis
    and cutoff (from numpy), and per-atom features."""
    R, cell = _box(3, seed=seed, jitter=0.3, stretch=1.1)
    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    refs = ColRefs.from_layout(lay)
    rij = PairwiseDistances()(dict(inputs))[TP.col_rij].numpy()
    d = np.sqrt(np.maximum((rij ** 2).sum(-1), 1e-15))
    f = np.exp(-((d[..., None] - np.linspace(0, CUTOFF, B)) ** 2))
    rcut = (0.5 * (np.cos(np.pi * d / CUTOFF) + 1) * (d < CUTOFF)
            * (lay.qcol >= 0))
    rng = np.random.RandomState(seed + 1)
    Ap = len(lay.order)
    f32 = np.float32
    return dict(
        lay=lay, refs=refs, jrefs=jcb.ColRefs.from_layout(lay),
        v=rij.astype(f32), d=d.astype(f32), f=f.astype(f32),
        rcut=rcut.astype(f32), q=(rng.randn(Ap, F) * 0.5).astype(f32),
        mu={k: (rng.randn(Ap, 3, F) * 0.5).astype(f32) for k in (EF, MF)},
        E={k: (rng.randn(Ap, 3) * 0.5).astype(f32) for k in (EF, MF)},
        Z=np.where(lay.slot_mask > 0, 18, 0),
        nmm=rng.randn(Ap, 3).astype(f32))


def _module_pair(name, c, F, B):
    """(flax module, its call on jax arrays, port module, its call on
    torch tensors, the differentiable inputs as numpy arrays)."""
    fields = (EF, MF)
    if name == "field_inter":
        args = (c["mu"], c["E"])
        return (jfs.FieldInteraction(F, fields),
                lambda m, mu, E: m(mu, E),
                tfs.FieldInteraction(F, fields),
                lambda m, mu, E: m(mu, E), args)
    if name == "dipole_update":
        args = (c["q"], c["mu"], c["v"], c["rcut"])
        return (jfs.DipoleUpdate(F, fields),
                lambda m, q, mu, v, r: m(q, mu, v, r, None, None,
                                         col_refs=c["jrefs"]),
                tfs.DipoleUpdate(F, fields),
                lambda m, q, mu, v, r: m(q, mu, v, r, c["refs"]), args)
    if name == "dipole_inter":
        args = (c["mu"], c["f"], c["d"], c["v"], c["rcut"])
        return (jfs.DipoleInteraction(F, fields),
                lambda m, mu, f, d, v, r: m(mu, f, d, v, r, None, None,
                                            col_refs=c["jrefs"]),
                tfs.DipoleInteraction(F, B, fields),
                lambda m, mu, f, d, v, r: m(mu, f, d, v, r, c["refs"]), args)
    args = (c["nmm"],)
    return (jfs.NuclearMagneticMomentEmbedding(F),
            lambda m, nmm: m(jnp.asarray(c["Z"]), nmm),
            tfs.NuclearMagneticMomentEmbedding(F),
            lambda m, nmm: m(torch.tensor(c["Z"]), nmm), args)


@pytest.mark.parametrize("name", ["field_inter", "dipole_update",
                                  "dipole_inter", "nmm"])
def test_module_and_vjp_match_flax(name):
    """Each FieldSchNet module alone, its output and the cotangents of its
    inputs, against the flax module with the same (perturbed) params."""
    F, B = 8, 6
    c = _edge_case(seed=2, F=F, B=B)
    jmod, jcall, tmod, tcall, args = _module_pair(name, c, F, B)
    jargs = jax.tree_util.tree_map(jnp.asarray, args)
    params = _perturbed(jmod.init(jax.random.PRNGKey(3),
                                  *jargs, method=lambda m, *a: jcall(m, *a)),
                        seed=4)
    want, vjp = jax.vjp(
        lambda *a: jmod.apply(params, *a, method=lambda m, *b: jcall(m, *b)),
        *jargs)
    rng = np.random.RandomState(5)
    g = jax.tree_util.tree_map(
        lambda w: rng.randn(*w.shape).astype(np.float32), want)
    want_g = vjp(jax.tree_util.tree_map(jnp.asarray, g))

    sd = {}
    _tree("m", params["params"], sd)
    tmod.load_state_dict({k[2:]: torch.tensor(np.asarray(v))
                          for k, v in sd.items()})
    targs = jax.tree_util.tree_map(
        lambda a: torch.tensor(a).requires_grad_(True), args)
    got = tcall(tmod, *targs)
    flat_in = jax.tree_util.tree_leaves(targs)
    flat_got = jax.tree_util.tree_leaves(got)
    grads = torch.autograd.grad(
        flat_got, flat_in,
        [torch.tensor(x) for x in jax.tree_util.tree_leaves(g)],
        allow_unused=True)
    for w, o in zip(jax.tree_util.tree_leaves(want), flat_got):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w),
                                   MOD_RTOL, MOD_ATOL)
    for w, o in zip(jax.tree_util.tree_leaves(want_g), grads):
        got_g = np.zeros(w.shape, np.float32) if o is None else o.numpy()
        np.testing.assert_allclose(got_g, np.asarray(w), MOD_RTOL, MOD_ATOL)
    assert max(float(np.abs(np.asarray(w)).max())
               for w in jax.tree_util.tree_leaves(want)) > 1e-3


# -------------------------------------------------------------------- model
#: (external_fields, response_properties, field inputs, with moments)
CASES = {
    "zero_field": ((EF,), None, (), False),
    "electric_field": ((EF,), None, (EF,), False),
    "magnetic_nmm": ((EF, MF), None, (EF, MF), True),
    "response_properties": ((EF,), (P.shielding,), (MF,), False),
}


def _jax_potential(F, T, B, fields=(EF,), response=None):
    return JNNP(
        representation=JFieldSchNet(n_atom_basis=F, n_interactions=T,
                                    n_rbf=B, cutoff=CUTOFF,
                                    external_fields=fields,
                                    response_properties=response),
        input_modules=[JPairwiseDistances()],
        output_modules=[JAtomwise(output_key=P.energy), JForces()])


def port_field_schnet(params=None, F=128, T=5, B=20, fields=(EF,),
                      response=None, nmm=True):
    pot = NeuralNetworkPotential(
        FieldSchNet(n_atom_basis=F, n_interactions=T, n_rbf=B, cutoff=CUTOFF,
                    external_fields=fields, response_properties=response,
                    nmm_embedding=nmm),
        [Atomwise(n_in=F), Forces()], input_modules=[PairwiseDistances()])
    if params is not None:
        pot.load_state_dict(params)
    return pot.requires_grad_(False)


def _case_inputs(name, seed=1):
    """(layout, port inputs, JAX inputs) of a model case on a periodic
    box, with its fields and moments from numpy."""
    _, _, given, nmm = CASES[name]
    R, cell = _box(3, seed=seed, jitter=0.3, stretch=1.1)
    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    jin = _jax_column_inputs(lay, inputs)
    rng = np.random.RandomState(seed + 7)
    extra = {f: rng.uniform(-0.3, 0.3, (1, 3)).astype(np.float32)
             for f in given}
    if nmm:
        extra[P.nuclear_magnetic_moments] = rng.randn(
            len(lay.order), 3).astype(np.float32)
    for k, v in extra.items():
        inputs[k] = torch.tensor(v)
        jin[k] = jnp.asarray(v)
    return lay, inputs, jin


def _energy(pot, inputs):
    return float(pot(dict(inputs))[TP.energy][0])


@pytest.mark.parametrize("name", list(CASES))
def test_small_field_schnet_matches_jax_column_path(name):
    """FieldSchNet-16x2 (B = 8), seeded flax init with perturbed dipole
    filters: energy and forces against the JAX column path; the dipole
    term, and the case's fields or moments, move the energy."""
    F, T, B = 16, 2, 8
    fields, response, given, nmm = CASES[name]
    lay, inputs, jin = _case_inputs(name)
    jpot = _jax_potential(F, T, B, fields, response)
    tree = _perturbed(jpot.init(jax.random.PRNGKey(0), jin), seed=1)
    out = jpot.apply(tree, jin)
    pot = port_field_schnet(params_from_jax(tree), F, T, B, fields, response,
                            nmm)
    got = pot(dict(inputs))
    E = float(got[TP.energy][0])
    np.testing.assert_allclose(E, float(np.asarray(out[P.energy])[0]),
                               rtol=E_RTOL)
    np.testing.assert_allclose(got[TP.forces].numpy(),
                               np.asarray(out[P.forces]), rtol=F_RTOL,
                               atol=F_ATOL)
    assert np.abs(got[TP.forces].numpy()).max() > 1e-3
    assert set(pot.representation.fields) == set(fields) | (
        {MF} if response else set())

    def moved(other):
        return abs(other - E) > TERM_RTOL * abs(E)

    zeroed = port_field_schnet(params_from_jax(_zero_dipole_filters(tree)),
                               F, T, B, fields, response, nmm)
    assert moved(_energy(zeroed, inputs)), "the dipole term is inert"
    for k in given + ((P.nuclear_magnetic_moments,) if nmm else ()):
        assert moved(_energy(pot, {a: b for a, b in inputs.items()
                                   if a != k})), f"{k} is inert"


def test_params_from_jax_covers_every_field_schnet_parameter():
    """Both fields and the moments' embedding: every parameter of the port
    has its flax leaf, with its shape."""
    fields = (EF, MF)
    lay, inputs, jin = _case_inputs("magnetic_nmm")
    tree = _jax_potential(8, 2, 4, fields).init(jax.random.PRNGKey(2), jin)
    params = params_from_jax(jax.device_get(tree))
    state = port_field_schnet(F=8, T=2, B=4, fields=fields).state_dict()
    assert set(params) == set(state)
    for k, v in params.items():
        assert v.shape == state[k].shape, k
    assert params["representation.dipole_inter.1.filter_magnetic_field_1."
                  "weight"].shape == (8, 8)
    assert params["representation.nmm_embedding.gyromagnetic.weight"].shape \
        == (101, 1)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert len(params) == n_leaves


def test_field_schnet_selects_as_often_as_its_kernels_launch(monkeypatch):
    """One force evaluation at 5 interactions runs the gathers and folds as
    the MD step on the card launches K11-K14 (their twins stand in here),
    by width: the positions' (D = 3) gather, expand and VJPs once; at D =
    F and 3F, 15 gathers and 15 folds (the last block's dipole update is
    not computed), 15 expands (the folds' VJPs) and 13 gather VJPs (the
    initial update's and block 0's SchNet gathers read the frozen
    embedding)."""
    counts = {}
    for name in sel.LAUNCHES:
        def counted(*args, _name=name, _plain=getattr(sel, f"{name}_plain")):
            key = (_name, args[0].shape[-1])
            counts[key] = counts.get(key, 0) + 1
            return _plain(*args)
        monkeypatch.setattr(sel, f"{name}_plain", counted)
    F = 8
    lay, inputs, _ = _case_inputs("zero_field")
    port_field_schnet(F=F, T=5, B=4)(inputs)
    assert counts == {
        ("gather_fwd", 3): 1, ("gather_bwd", 3): 1, ("expand_fwd", 3): 1,
        ("fold_fwd", 3): 1,
        ("gather_fwd", F): 10, ("gather_fwd", 3 * F): 5,
        ("gather_bwd", F): 8, ("gather_bwd", 3 * F): 5,
        ("fold_fwd", F): 5, ("fold_fwd", 3 * F): 10,
        ("expand_fwd", F): 5, ("expand_fwd", 3 * F): 10}


def test_field_schnet_refuses_other_layouts():
    with pytest.raises(NotImplementedError, match="column layout"):
        port_field_schnet(F=8, T=1, B=4).representation(
            {TP.R: torch.zeros(4, 3)})


# ---------------------------------------------------------------------- MD
N_STEPS = 20
SKIN = 0.04          # Angstrom: small, so the skin criterion fires
TEMPERATURE = 100.0  # K, initial momenta


def _md_start():
    rng = np.random.RandomState(3)
    R, cell = fcc_box(4)
    R = R + rng.uniform(-0.1, 0.1, R.shape)
    mol = {P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
           P.pbc: np.ones(3, bool)}
    masses = 39.948 * md_units().mass
    sigma = np.sqrt(masses * md_units().kB * TEMPERATURE)
    p0 = (sigma * rng.randn(1, len(R), 3)).astype(np.float32)
    p0 -= p0.mean(axis=1, keepdims=True)
    return mol, p0


def test_field_schnet_nve_trajectory_matches_jax():
    """20 NVE steps of the 256-atom box with FieldSchNet-16x2 (perturbed
    dipole filters) through both packages' ``SchNetPackCalculator`` on the
    column layout, from the same positions and momenta, with rebuilds on
    the way: positions, momenta and energies agree."""
    F, T, B = 16, 2, 8
    mol, p0 = _md_start()
    conv = _parse_unit("Ang") * md_units().length
    lay, _, jin = _case_inputs("zero_field")
    jpot = _jax_potential(F, T, B)
    tree = _perturbed(jpot.init(jax.random.PRNGKey(5), jin), seed=6)

    jsystem = jload_molecules([mol]).replace(momenta=jnp.asarray(p0))
    jcalc = JCalculator(jpot, tree, cutoff=CUTOFF, cutoff_shell=SKIN,
                        neighbor_list=JCellBlockNBL(
                            CUTOFF * conv, skin=SKIN * conv,
                            layout="column"))
    jsim = JSimulator(jsystem, JVelocityVerlet(0.5), jcalc, progress=False,
                      log_keys=("energy", "temperature"))
    jsim.simulate(N_STEPS, chunk_size=N_STEPS)
    s = jsim.state.system

    system = load_molecules([mol], device="cpu").replace(
        momenta=torch.tensor(p0))
    nbl = CellBlockNeighborListMD(CUTOFF * conv, skin=SKIN * conv)
    calc = SchNetPackCalculator(port_field_schnet(F=F, T=T, B=B),
                                params_from_jax(tree), cutoff=CUTOFF,
                                cutoff_shell=SKIN, neighbor_list=nbl)
    sim = Simulator(system, VelocityVerlet(0.5), calc)
    sim.simulate(N_STEPS, chunk_size=10)
    assert nbl.n_device_builds >= 1, "no rebuild went through the device"
    np.testing.assert_allclose(sim.system.positions.numpy(),
                               np.asarray(s.positions), rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(sim.system.momenta.numpy(),
                               np.asarray(s.momenta), rtol=MOM_RTOL,
                               atol=MOM_ATOL)
    np.testing.assert_allclose(sim.system.energy.numpy(),
                               np.asarray(s.energy), rtol=E_RTOL)


# ------------------------------------------------------- asset and fixture
def test_field_schnet_bench_asset_matches_jax():
    """The trained FieldSchNet-128x5 on the 256-atom box, no field."""
    R, cell = _box(4, seed=0, jitter=0.15)
    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    tree = load_jax_params(ASSET)
    out = _jax_potential(128, 5, 20).apply(tree,
                                           _jax_column_inputs(lay, inputs))
    got = port_field_schnet(params_from_jax(tree))(inputs)
    np.testing.assert_allclose(float(got[TP.energy][0]),
                               float(np.asarray(out[P.energy])[0]),
                               rtol=E_RTOL)
    np.testing.assert_allclose(got[TP.forces].numpy(),
                               np.asarray(out[P.forces]), rtol=F_RTOL,
                               atol=F_ATOL)
    assert np.abs(got[TP.forces].numpy()).max() > 0.05


def test_params_from_jax_covers_the_bench_asset():
    params = params_from_jax(load_jax_params(ASSET))
    state = port_field_schnet().state_dict()
    assert set(params) == set(state)
    for k, v in params.items():
        assert v.shape == state[k].shape, k
    assert params["representation.dipole_inter.4.filter_electric_field_0."
                  "weight"].shape == (128, 20)


def test_field_schnet_reference_fixture_is_the_bench_box():
    """The full-size fixture (``scripts/make_port_reference_field_schnet.
    py``) holds the jittered 10,976-atom bench box with finite energy and
    forces whose net force vanishes, and the dipole-dipole term's share."""
    ref = np.load(FIXTURE)
    R0, cell = fcc_box(14)
    assert ref["R"].shape == (10976, 3) and ref["forces"].shape == (10976, 3)
    np.testing.assert_allclose(ref["cell"], cell)
    jitter = ref["R"] - R0
    assert np.abs(jitter).max() <= float(ref["jitter"]) + 1e-5
    assert np.isfinite(ref["energy"]) and np.isfinite(ref["forces"]).all()
    assert np.abs(ref["forces"].sum(0)).max() < 1e-2
    assert int(ref["n_pairs"]) > 0
    assert np.isfinite(ref["force_rms_without_dipole_filters"])
