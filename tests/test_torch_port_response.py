"""PyTorch port, the response engine (``model/base.py``) against the JAX
package's ``apply`` on the same inputs and parameters:

* FieldSchNet-16x2 with both fields and nuclear moments, every response
  of ``Response`` (forces, dipole, polarizability, partial charges,
  dipole and polarizability derivatives, shielding, spin coupling,
  Hessian) at a nonzero field, on the flat layout;
* the Hessian of PaiNN and SchNet, and its per-molecule block form on a
  two-molecule batch against each molecule's dense Hessian;
* stress: ``Forces(calc_stress=True)`` through the MD calculator on the
  flat (``all_pairs``), dense and 27-cell (the CPU twins of K16-K19)
  layouts of a periodic argon box against the JAX flat layout, and dE/deps
  against a central finite difference of the energy in float64;
* the column layout: the JAX package's column stress differs from its
  flat stress (its ``Strain`` does not reach the column offsets), and the
  port refuses it with ``ColumnStressError``; second-order responses on
  the column and 27-cell layouts raise ``SecondOrderLayoutError``;
* ``nn/utils.py``'s derivative helpers against ``jax.jacrev``.

Weights: the flax init with every zero-initialised leaf perturbed from a
numpy seed (so FieldSchNet's dipole filters are live), through
``convert.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import atomistic as ja
from schnetpack_tpu import properties as P
from schnetpack_tpu.data.loader import PaddingSpec, collate, padding_for
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.nn import utils as jutils
from schnetpack_tpu.ops import cellblock as jcellblock
from schnetpack_tpu.representation import FieldSchNet as JFieldSchNet
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu.representation import SchNet as JSchNet
from schnetpack_tpu.transform.neighborlist import NeighborListTransform
from schnetpack_tpu_torch import atomistic as ta
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.convert import params_from_jax
from schnetpack_tpu_torch.md import load_molecules
from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.model.base import (
    ColumnStressError, SecondOrderLayoutError,
)
from schnetpack_tpu_torch.nn import utils as tutils
from schnetpack_tpu_torch.representation import FieldSchNet, PaiNN, SchNet
from test_torch_port_heads import as_torch, init_tree, molecules
from test_torch_port_model import port_inputs
from test_torch_port_so3net import _box, _jax_column_inputs
from torch_port_cases import fcc_argon

CUTOFF = 5.0
F_, T_, B_ = 16, 2, 8
# a response against JAX: max |got - want| over max |want|, f32 roundoff
# of one (first order) or two (second order) backward passes
FIRST_RTOL = 1e-5
SECOND_RTOL = 1e-4
# stress: f32 roundoff of the strain derivative over a 108-atom box,
# against max |sigma|
STRESS_RTOL = 1e-4
# the finite difference in float64: step and agreement
FD_STEP, FD_RTOL = 1e-5, 1e-6
#: every response of FieldSchNet with both fields
FIELD_RESPONSES = [
    P.forces, P.dipole_moment, P.polarizability, P.partial_charges,
    P.dipole_derivatives, P.polarizability_derivatives, P.shielding,
    P.nuclear_spin_coupling, P.hessian]
REPRESENTATIONS = {"painn": (JPaiNN, PaiNN), "schnet": (JSchNet, SchNet)}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jcellblock, "IMPL", "xla")


def blocks_of(want, got):
    """A jitted JAX apply traces the atom counts and gives blocks of the
    batch's atom count; its slots beyond the port's largest molecule are
    zero, and the rest is the port's shape."""
    want = np.asarray(want)
    a = got.shape[1]
    assert np.abs(want[:, a:]).max(initial=0.0) == 0.0
    assert np.abs(want[:, :, :, a:]).max(initial=0.0) == 0.0
    return want[:, :a, :, :a]


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def field_batch():
    """Two molecules (5 and 8 atoms, two padding atoms) with a nonzero
    electric and magnetic field and nuclear moments, the linearisation
    point of every response."""
    samples = molecules((5, 8))
    A = sum(len(s[P.Z]) for s in samples)
    b = collate(samples, PaddingSpec(A + 2, sum(len(s[P.idx_i])
                                                for s in samples) + 8, 3))
    rng = np.random.RandomState(7)
    b[P.electric_field] = (0.1 * rng.randn(3, 3)).astype(np.float32)
    b[P.magnetic_field] = (0.1 * rng.randn(3, 3)).astype(np.float32)
    b[P.nuclear_magnetic_moments] = (
        0.1 * rng.randn(A + 2, 3) * (np.arange(A + 2) < A)[:, None]
    ).astype(np.float32)
    return b, A, len(samples)


def _field_pair(props):
    common = dict(n_atom_basis=F_, n_interactions=T_, n_rbf=B_,
                  cutoff=CUTOFF, response_properties=props)
    jpot = JNNP(representation=JFieldSchNet(**common),
                input_modules=[ja.PairwiseDistances()],
                output_modules=[ja.Atomwise(output_key=P.energy),
                                ja.Response(response_properties=props)])
    pot = NeuralNetworkPotential(
        FieldSchNet(**common),
        [ta.Atomwise(F_), ta.Response(response_properties=props)],
        input_modules=[ta.PairwiseDistances()])
    return jpot, pot


@functools.lru_cache(maxsize=None)
def _field_outputs():
    b, A, M = field_batch()
    jpot, pot = _field_pair(FIELD_RESPONSES)
    tree = init_tree(jpot, b)
    jout = jax.jit(jpot.apply)(tree, b)
    pot.load_state_dict(params_from_jax(tree))
    out = pot.requires_grad_(False)(as_torch(b))
    return jout, out, A, M


@pytest.mark.parametrize("prop", FIELD_RESPONSES)
def test_field_schnet_response_matches_jax(prop):
    jout, out, A, M = _field_outputs()
    want, got = np.asarray(jout[prop]), out[prop].numpy()
    if prop in (P.hessian, P.nuclear_spin_coupling):
        want = blocks_of(want, got)
    assert got.shape == want.shape
    tol = FIRST_RTOL if prop in (P.forces, P.dipole_moment) else SECOND_RTOL
    assert np.abs(want).max() > 1e-4, prop      # a live response
    assert rel_err(got, want) <= tol, (prop, rel_err(got, want))
    assert np.isfinite(got).all()


def test_field_schnet_energy_matches_jax():
    jout, out, _, M = _field_outputs()
    np.testing.assert_allclose(out[TP.energy].numpy()[:M],
                               np.asarray(jout[P.energy])[:M], rtol=1e-5)


def _hessian_pair(name):
    J, T = REPRESENTATIONS[name]
    common = dict(n_atom_basis=F_, n_interactions=T_, n_rbf=B_,
                  cutoff=CUTOFF)
    props = [P.forces, P.hessian]
    jpot = JNNP(representation=J(**common),
                input_modules=[ja.PairwiseDistances()],
                output_modules=[ja.Atomwise(output_key=P.energy),
                                ja.Response(response_properties=props)])
    pot = NeuralNetworkPotential(
        T(**common), [ta.Atomwise(F_), ta.Response(response_properties=props)],
        input_modules=[ta.PairwiseDistances()])
    return jpot, pot


@pytest.mark.parametrize("name", sorted(REPRESENTATIONS))
def test_hessian_matches_jax(name):
    b, A, M = field_batch()
    jpot, pot = _hessian_pair(name)
    tree = init_tree(jpot, b)
    jout = jax.jit(jpot.apply)(tree, b)
    pot.load_state_dict(params_from_jax(tree))
    out = pot.requires_grad_(False)(as_torch(b))
    H = out[P.hessian].numpy()
    H_ref = blocks_of(jout[P.hessian], H)
    assert H.shape == H_ref.shape == (3, 8, 3, 8, 3)
    assert rel_err(H, H_ref) <= SECOND_RTOL
    assert rel_err(out[P.forces].numpy(), jout[P.forces]) <= FIRST_RTOL


def test_hessian_blocks_are_each_molecules_dense_hessian():
    """The block form on a two-molecule batch: each molecule's block is
    its own dense Hessian (a double loop of ``torch.autograd.grad`` over
    that molecule alone), padded slots zero."""
    b, A, M = field_batch()
    jpot, pot = _hessian_pair("painn")
    pot.load_state_dict(params_from_jax(init_tree(jpot, b)))
    pot.requires_grad_(False)
    H = pot(as_torch(b))[P.hessian]
    sizes = np.bincount(np.asarray(b[P.idx_m])[:A], minlength=M)
    for m, n in enumerate(sizes):
        sample = molecules((5, 8))[m]
        one = collate([sample], padding_for([sample]))
        inputs = as_torch(one)
        R = inputs[TP.R].requires_grad_(True)
        energy_only = NeuralNetworkPotential(
            pot.representation, [pot.output_modules[0]],
            input_modules=[ta.PairwiseDistances()])
        with torch.enable_grad():
            E = energy_only(inputs)[TP.energy][0]
            (g,) = torch.autograd.grad(E, R, create_graph=True)
            dense = torch.stack([torch.autograd.grad(
                g.reshape(-1)[k], R, retain_graph=True)[0][:n].reshape(-1)
                for k in range(3 * n)]).reshape(n, 3, n, 3)
        block = H[m, :n, :, :n, :]
        torch.testing.assert_close(block, dense, rtol=1e-4, atol=1e-4)
        assert np.abs(H[m, n:].numpy()).max(initial=0.0) == 0.0
        assert np.abs(H[m, :, :, n:].numpy()).max(initial=0.0) == 0.0
    assert np.abs(H[M:].numpy()).max(initial=0.0) == 0.0


# ----------------------------------------------------------------- stress
def _argon():
    R, cell = fcc_argon(3, jitter=0.2, seed=1)
    return {P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
            P.pbc: np.ones(3, bool)}


def _stress_pair():
    common = dict(n_atom_basis=F_, n_interactions=T_, n_rbf=B_,
                  cutoff=CUTOFF)
    jpot = JNNP(representation=JPaiNN(**common),
                input_modules=[ja.PairwiseDistances()],
                output_modules=[ja.Atomwise(output_key=P.energy),
                                ja.Forces(calc_stress=True)])
    pot = NeuralNetworkPotential(
        PaiNN(**common), [ta.Atomwise(F_), ta.Forces(calc_stress=True)],
        input_modules=[ta.PairwiseDistances()])
    return jpot, pot


@functools.lru_cache(maxsize=None)
def _stress_reference():
    s = NeighborListTransform(CUTOFF)(_argon())
    b = collate([s], padding_for([s]))
    jpot, _ = _stress_pair()
    tree = init_tree(jpot, b)
    out = jax.jit(jpot.apply)(tree, b)
    return tree, np.asarray(out[P.stress])[0], np.asarray(out[P.energy])[0]


@pytest.mark.parametrize("neighbor_list",
                         ["all_pairs", "dense", "cellblock_atom"])
def test_stress_matches_jax_flat(neighbor_list):
    """The calculator's stress (``System.stress`` in model units) on each
    layout against the JAX flat layout's."""
    tree, sigma_ref, E_ref = _stress_reference()
    _, pot = _stress_pair()
    calc = SchNetPackCalculator(pot, params_from_jax(tree), cutoff=CUTOFF,
                                cutoff_shell=0.3, stress_key=P.stress,
                                neighbor_list=neighbor_list)
    system = load_molecules([_argon()], device="cpu")
    if neighbor_list == "cellblock_atom":
        assert TP.cell_qidx in calc.model_inputs(system,
                                                 calc.init_state(system))
    s = calc.calculate(system, calc.init_state(system))
    sigma = s.stress.numpy()[0, 0] / calc.stress_conversion
    assert rel_err(sigma, sigma_ref) <= STRESS_RTOL, (sigma, sigma_ref)
    np.testing.assert_allclose(s.energy.numpy()[0, 0]
                               / calc.energy_conversion, E_ref, rtol=1e-5)


def test_stress_is_the_strain_derivative_of_the_energy():
    """sigma V = dE/deps against a central difference of the energy of
    the strained box (positions and cell), in float64 on the flat
    layout."""
    tree, _, _ = _stress_reference()
    _, pot = _stress_pair()
    pot.load_state_dict(params_from_jax(tree))
    pot = pot.double().requires_grad_(False)
    box = _argon()

    def run(eps):
        strained = dict(box)
        strained[P.R] = box[P.R] @ (np.eye(3) + eps)
        strained[P.cell] = box[P.cell] @ (np.eye(3) + eps)
        s = NeighborListTransform(CUTOFF)(strained)
        b = collate([s], padding_for([s]), float_dtype=np.float64)
        return pot({k: torch.as_tensor(np.asarray(v)) for k, v in b.items()})
    out = run(np.zeros((3, 3)))
    V = abs(np.linalg.det(box[P.cell]))
    dEde = out[P.stress].numpy()[0] * V
    fd = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            e = np.zeros((3, 3))
            e[i, j] = e[j, i] = FD_STEP / (1 if i == j else 2)
            fd[i, j] = (float(run(e)[P.energy][0])
                        - float(run(-e)[P.energy][0])) / (2 * FD_STEP)
    assert np.abs(dEde).max() > 1e-3
    np.testing.assert_allclose(dEde, fd, rtol=0,
                               atol=FD_RTOL * np.abs(dEde).max())


def test_jax_column_stress_differs_from_its_flat_stress():
    """The reference side: the JAX ``Strain`` strains R and the cell but
    not ``cell_coff``, so the JAX column layout's stress misses the
    periodic-image term and disagrees with its flat layout's (by more
    than half of it), while the energies agree; the port refuses stress
    there."""
    R, cell = _box(3, seed=1, jitter=0.3, stretch=1.1)
    jpot, pot = _stress_pair()
    s = NeighborListTransform(CUTOFF)({P.Z: np.full(len(R), 18), P.R: R,
                                       P.cell: cell,
                                       P.pbc: np.ones(3, bool)})
    b = collate([s], padding_for([s]))
    tree = init_tree(jpot, b)
    flat = jax.jit(jpot.apply)(tree, b)
    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    ci = _jax_column_inputs(lay, inputs)
    ci[P.cell] = jnp.asarray(cell[None].astype(np.float32))
    col = jpot.apply(tree, ci)
    np.testing.assert_allclose(float(col[P.energy][0]),
                               float(flat[P.energy][0]), rtol=1e-5)
    assert rel_err(col[P.stress][0], flat[P.stress][0]) > 0.5
    pot.load_state_dict(params_from_jax(tree))
    inputs[TP.cell] = torch.tensor(cell[None], dtype=torch.float32)
    with pytest.raises(ColumnStressError, match="periodic-image"):
        pot.requires_grad_(False)(inputs)


@pytest.mark.parametrize("layout", ["column", "cell"])
def test_second_order_on_blocked_layouts_raises(layout):
    jpot, pot = _hessian_pair("painn")
    R, cell = _box(3, seed=1, jitter=0.3, stretch=1.1)
    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    if layout == "cell":
        inputs = {k: v for k, v in inputs.items()
                  if not k.startswith("_cell_")}
        inputs[TP.cell_qidx] = torch.zeros((1, 1, 1, 1, 1), dtype=torch.int32)
    with pytest.raises(SecondOrderLayoutError, match="hessian"):
        pot.requires_grad_(False)(inputs)


def test_derivative_helpers_match_jax():
    """``derivative_from_molecular`` and ``derivative_from_atomic`` of a
    smooth map against ``jax.jacrev`` with the same masking (JAX in
    float32, so f32 roundoff)."""
    rng = np.random.RandomState(3)
    x = rng.randn(5, 3)
    W = rng.randn(3, 3)
    idx_m = np.array([0, 0, 1, 1, 1])

    def jfn(r):
        return jnp.tanh(r @ W) * jnp.sum(r ** 2, axis=1, keepdims=True)

    def tfn(r):
        return torch.tanh(r @ torch.tensor(W)) * (r ** 2).sum(1, keepdim=True)
    want = np.asarray(jutils.derivative_from_molecular(jfn, jnp.asarray(x)))
    got = tutils.derivative_from_molecular(tfn, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want = np.asarray(jutils.derivative_from_atomic(
        jfn, jnp.asarray(x), jnp.asarray(idx_m), 2))
    got = tutils.derivative_from_atomic(tfn, torch.tensor(x),
                                        torch.tensor(idx_m), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    shared = tutils.replicate_module(lambda: torch.nn.Linear(2, 2), 3, True)
    assert len(shared) == 3 and shared[0] is shared[2]
