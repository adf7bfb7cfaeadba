"""PyTorch port, the model options of SchNet, PaiNN and SO3net against the
JAX package's column path: nuclear and electronic embeddings, shared
interactions, PaiNN's shared filters (in both message forms, with the
filter weights' gradient), trainable Gaussian bases with their centre and
width gradients, and SO3net's vector representation; plus the flat and
dense inputs, which every representation runs.

Inputs are made with numpy from fixed seeds and handed to both packages;
the JAX package runs its XLA path (``IMPL="xla"``) on the CPU.  Every
zero-initialised parameter (the nuclear element table, the electronic
keys and values, the residual blocks' last layers) is perturbed from a
numpy seed, and the cases check that the option's term changes the
energy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.atomistic import Atomwise as JAtomwise
from schnetpack_tpu.atomistic import Forces as JForces
from schnetpack_tpu.atomistic import PairwiseDistances as JPairwiseDistances
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.nn.radial import GaussianRBF as JGaussianRBF
from schnetpack_tpu.ops import cellblock as jcellblock
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu.representation import SchNet as JSchNet
from schnetpack_tpu.representation import SO3net as JSO3net
from schnetpack_tpu_torch import nn as tnn
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic import Atomwise, Forces, PairwiseDistances
from schnetpack_tpu_torch.convert import params_from_jax
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.representation import (
    FieldSchNet, PaiNN, SchNet, SO3net,
)
from test_torch_port_model import port_inputs
from test_torch_port_so3net import _box, _jax_column_inputs
from torch_port_cases import pair_layout_inputs

CUTOFF = 5.0
F_, T_, B_ = 16, 2, 8
# whole model: energy relative; forces elementwise
E_RTOL = 1e-5
F_RTOL, F_ATOL = 1e-4, 1e-5
# parameter gradients, normwise: f32 sums over every edge
GRAD_RTOL = 1e-4
# a term "changes the energy" when it moves it by more than ten times the
# energy's tolerance
TERM_RTOL = 10 * E_RTOL
CHARGE, SPIN = -1.0, 2.0


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jcellblock, "IMPL", "xla")


#: (model, option) -> the keyword arguments of both packages'
#: representation; "trainable_basis" adds the basis modules
CASES = {
    ("schnet", "nuclear_embedding"): dict(nuclear_embedding=True),
    ("schnet", "electronic_embeddings"): dict(
        electronic_embeddings=("charge", "spin")),
    ("schnet", "shared_interactions"): dict(shared_interactions=True),
    ("schnet", "trainable_basis"): {},
    ("painn", "shared_interactions"): dict(shared_interactions=True),
    ("painn", "shared_filters"): dict(shared_filters=True),
    ("painn", "nuclear_embedding"): dict(nuclear_embedding=True),
    ("painn", "electronic_embeddings"): dict(
        electronic_embeddings=("charge", "spin")),
    ("so3net", "shared_interactions"): dict(shared_interactions=True),
    ("so3net", "trainable_basis"): {},
    ("so3net", "vector_representation"): dict(
        return_vector_representation=True),
}
PARAMS = [pytest.param(m, o, fuse, id=f"{m}-{o}" + (f"-{fuse}" if fuse
                                                      else ""))
          for (m, o) in CASES
          for fuse in (("full", "hybrid") if m == "painn" else (None,))]


def _models(model, option, fuse, forces=True):
    """(JAX potential, port potential) of a case, with the energy head and,
    with ``forces``, the forces."""
    kw = dict(CASES[(model, option)])
    jkw, tkw = dict(kw), dict(kw)
    if option == "trainable_basis":
        jkw["radial_basis"] = JGaussianRBF(n_rbf=B_, cutoff=CUTOFF,
                                           trainable=True)
        tkw["radial_basis"] = tnn.GaussianRBF(B_, CUTOFF, trainable=True)
    common = dict(n_atom_basis=F_, n_interactions=T_, n_rbf=B_,
                  cutoff=CUTOFF)
    jinputs, tinputs = [JPairwiseDistances()], [PairwiseDistances()]
    if model == "schnet":
        jrep, trep = JSchNet(**common, **jkw), SchNet(**common, **tkw)
        jinputs, tinputs = [], []
    elif model == "painn":
        jrep, trep = JPaiNN(**common, **jkw), PaiNN(**common, fuse=fuse,
                                                    **tkw)
        tinputs = []
    else:
        jrep = JSO3net(**common, lmax=2, **jkw)
        trep = SO3net(**common, lmax=2, **tkw)
    jheads = [JAtomwise(output_key=P.energy)] + ([JForces()] if forces
                                                 else [])
    theads = [Atomwise(n_in=F_)] + ([Forces()] if forces else [])
    return (JNNP(representation=jrep, input_modules=jinputs,
                 output_modules=jheads),
            NeuralNetworkPotential(trep, theads, input_modules=tinputs))


def _case_inputs(option):
    """(port inputs, JAX inputs) on a periodic box of 108 atoms, with a
    total charge and a spin for the electronic embeddings."""
    R, cell = _box(3, seed=1, jitter=0.3, stretch=1.1)
    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    jin = _jax_column_inputs(lay, inputs)
    if option == "electronic_embeddings":
        for k, v in ((P.total_charge, CHARGE), (P.spin_multiplicity, SPIN)):
            inputs[k] = torch.tensor([v])
            jin[k] = jnp.asarray([v], jnp.float32)
    return inputs, jin


def _perturbed(tree, seed):
    """A copy of a flax param tree whose all-zero leaves (zero-initialised
    kernels, tables, keys and values, and the biases) are seeded normal
    numbers x 0.3, and whose trainable basis's centres are shifted and
    widths scaled by seeded amounts."""
    rng = np.random.RandomState(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        node = np.asarray(node, np.float32)
        if name == "centers":
            return node + 0.1 * rng.randn(*node.shape).astype(np.float32)
        if name == "widths":
            return node * (1 + 0.1 * rng.randn(*node.shape)).astype(
                np.float32)
        if not node.any():
            return (0.3 * rng.randn(*node.shape)).astype(np.float32)
        return node
    return walk(jax.device_get(tree))


def _port(pot, tree):
    pot.load_state_dict(params_from_jax(tree))
    return pot.requires_grad_(False)


def _energy(pot, inputs):
    return float(pot(dict(inputs))[TP.energy][0])


@pytest.mark.parametrize("model, option, fuse", PARAMS)
def test_option_matches_jax_column_path(model, option, fuse):
    """Energy and forces of the option against the JAX package's column
    path at F = 16, 2 interactions, B = 8, seeded flax init with every
    zero-initialised parameter perturbed; the option's term moves the
    energy, and its parameters are where they should be."""
    inputs, jin = _case_inputs(option)
    jpot, pot = _models(model, option, fuse)
    tree = _perturbed(jpot.init(jax.random.PRNGKey(0), jin), seed=1)
    out = jpot.apply(tree, jin)
    pot = _port(pot, tree)
    got = pot(dict(inputs))
    E = float(got[TP.energy][0])
    np.testing.assert_allclose(E, float(np.asarray(out[P.energy])[0]),
                               rtol=E_RTOL)
    np.testing.assert_allclose(got[TP.forces].numpy(),
                               np.asarray(out[P.forces]), rtol=F_RTOL,
                               atol=F_ATOL)
    assert np.abs(got[TP.forces].numpy()).max() > 1e-3
    if option == "vector_representation":
        vec = got[TP.vector_representation].detach().numpy()
        np.testing.assert_allclose(
            vec, np.asarray(out[P.vector_representation]), rtol=F_RTOL,
            atol=F_ATOL)
        np.testing.assert_array_equal(
            vec, got[TP.multipole_representation].detach().numpy()[
                :, [3, 1, 2]])

    rep = pot.representation
    rep_tree = tree["params"]["representation"]
    if option == "shared_interactions":
        assert "interaction_shared" in rep_tree or "so3conv_shared" in \
            rep_tree
        blocks = rep.convs if model == "so3net" else rep.interactions
        assert len(blocks) == 1
    elif option == "shared_filters":
        assert rep.FW_aug.shape == (1, B_ + 1, 3 * F_)
    elif option == "nuclear_embedding":
        zeroed = dict(rep_tree, embedding=dict(
            rep_tree["embedding"], element_embedding=np.zeros_like(
                rep_tree["embedding"]["element_embedding"])))
        other = _port(_models(model, option, fuse)[1],
                      {"params": dict(tree["params"], representation=zeroed)})
        assert abs(_energy(other, inputs) - E) > TERM_RTOL * abs(E)
    elif option == "electronic_embeddings":
        neutral = {k: v for k, v in inputs.items()
                   if k not in (TP.total_charge, TP.spin_multiplicity)}
        assert abs(_energy(pot, neutral) - E) > TERM_RTOL * abs(E)
    elif option == "trainable_basis":
        assert isinstance(rep.radial_basis.centers, torch.nn.Parameter)


def _norm_close(got, want, what):
    d = float(np.linalg.norm(np.asarray(got, np.float64) - want))
    assert d <= GRAD_RTOL * float(np.linalg.norm(want)), (what, d)


@pytest.mark.parametrize("model", ["schnet", "so3net"])
def test_trainable_basis_gradients_match_jax(model):
    """The energy's gradient in the basis centres and widths: for SchNet
    through the plain raw-phi geometry and the cfconv's geometry
    cotangent, for SO3net through its plain basis."""
    inputs, jin = _case_inputs("trainable_basis")
    jpot, pot = _models(model, "trainable_basis", None, forces=False)
    tree = _perturbed(jpot.init(jax.random.PRNGKey(2), jin), seed=3)
    want = jax.grad(lambda p: jpot.apply(p, jin)[P.energy].sum())(tree)
    want = want["params"]["representation"]["radial_basis"]
    pot = _port(pot, tree)
    rb = pot.representation.radial_basis
    rb.requires_grad_(True)
    E = pot(dict(inputs))[TP.energy].sum()
    g_c, g_w = torch.autograd.grad(E, [rb.centers, rb.widths])
    _norm_close(g_c.numpy(), np.asarray(want["centers"]), "centers")
    _norm_close(g_w.numpy(), np.asarray(want["widths"]), "widths")
    assert float(g_c.abs().max()) > 1e-4


@pytest.mark.parametrize("fuse", ["full", "hybrid"])
def test_shared_filter_gradient_matches_jax(fuse):
    """PaiNN with shared filters: every interaction's message reads the
    one [B+1, 3F] slice of ``FW_aug``, and the energy's gradient in it is
    the sum of their cotangents, the JAX ``filter_net``'s kernel and bias
    gradients."""
    inputs, jin = _case_inputs("shared_filters")
    jpot, pot = _models("painn", "shared_filters", fuse, forces=False)
    tree = _perturbed(jpot.init(jax.random.PRNGKey(4), jin), seed=5)
    want = jax.grad(lambda p: jpot.apply(p, jin)[P.energy].sum())(tree)
    want = want["params"]["representation"]["filter_net"]["linear"]
    pot = _port(pot, tree)
    FW = pot.representation.FW_aug
    FW.requires_grad_(True)
    (g,) = torch.autograd.grad(pot(dict(inputs))[TP.energy].sum(), [FW])
    _norm_close(g[0, :B_].numpy(), np.asarray(want["kernel"]), "kernel")
    _norm_close(g[0, B_].numpy(), np.asarray(want["bias"]), "bias")


def test_options_build_and_other_layouts_raise():
    """Every option of the JAX package's column path builds; SchNet takes a
    Bessel basis off the column layout and refuses it on the column path;
    the flat and dense inputs of a molecule run every representation and
    agree; inputs with no neighbor layout raise NotImplementedError."""
    for model in (SchNet, PaiNN):
        model(n_atom_basis=8, n_interactions=2, n_rbf=4,
              nuclear_embedding=True, electronic_embeddings=("charge",),
              shared_interactions=True)
    PaiNN(n_atom_basis=8, n_interactions=2, n_rbf=4, shared_filters=True)
    SchNet(n_atom_basis=8, n_interactions=2, n_rbf=4,
           radial_basis=tnn.GaussianRBF(4, CUTOFF, trainable=True))
    SO3net(n_atom_basis=8, n_interactions=2, n_rbf=4,
           shared_interactions=True, return_vector_representation=True,
           radial_basis=tnn.GaussianRBF(4, CUTOFF, trainable=True))
    bessel = SchNet(n_atom_basis=8, n_interactions=1, n_rbf=4,
                    radial_basis=tnn.BesselRBF(4, CUTOFF))
    R, cell = _box(3, seed=1, jitter=0.3, stretch=1.1)
    _, column = port_inputs(R, cell, CUTOFF + 0.6)
    with pytest.raises(NotImplementedError, match="GaussianRBF"):
        bessel(column)

    R = np.random.RandomState(3).rand(9, 3) * 4.0
    layouts = pair_layout_inputs(R, CUTOFF)
    reps = [SchNet(n_atom_basis=8, n_interactions=1, n_rbf=4),
            PaiNN(n_atom_basis=8, n_interactions=1, n_rbf=4),
            SO3net(n_atom_basis=8, n_interactions=1, n_rbf=4),
            FieldSchNet(n_atom_basis=8, n_interactions=1, n_rbf=4), bessel]
    for rep in reps:
        flat, dense = (rep(PairwiseDistances()(dict(ins)))[
            TP.scalar_representation] for ins in layouts)
        assert torch.isfinite(flat).all()
        torch.testing.assert_close(dense, flat, rtol=1e-5, atol=1e-6)
        with pytest.raises(NotImplementedError, match="neighbor layout"):
            rep({TP.R: torch.zeros(4, 3), TP.Z: torch.full((4,), 18)})