"""PyTorch port, the flat and dense layouts: PaiNN, SchNet, SO3net and
FieldSchNet against the JAX package on the same batches.

The batches are the JAX package's own collates (``data/loader.py``) of
three molecules of 5-12 atoms and the 108-atom argon box in one batch,
with four padding atoms: the flat pair list (padded pairs at a 1e3 A
offset, mask 0) and the dense [A, K] matrix with its reverse map, whose
flat list is the MD calculator's one-pair list that carries no pair (so
FieldSchNet takes its dense branch, as in MD).  Weights come from the
flax init with every zero-initialised parameter perturbed from a numpy
seed and are carried across by ``convert.py``.  Also: the parameter
gradients of PaiNN and SchNet on the flat layout, SchNet with a Bessel
basis, padded dense slots at Rij = 0 with finite gradients, and SchNet
and SO3net on the 27-cell atom layout (``cellblock_atom``, the CPU twins
of K16/K17) against the JAX flat batch.
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
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.nn.radial import BesselRBF as JBesselRBF
from schnetpack_tpu.ops import cellblock as jcellblock
from schnetpack_tpu.representation import FieldSchNet as JFieldSchNet
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu.representation import SchNet as JSchNet
from schnetpack_tpu.representation import SO3net as JSO3net
from schnetpack_tpu.transform.neighborlist import NeighborListTransform
from schnetpack_tpu_torch import nn as tnn
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic import Atomwise, Forces, PairwiseDistances
from schnetpack_tpu_torch.convert import params_from_jax
from schnetpack_tpu_torch.md import load_molecules
from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.representation import (
    FieldSchNet, PaiNN, SchNet, SO3net,
)
from test_torch_port_model_options import _perturbed
from torch_port_cases import fcc_argon, grads_close

CUTOFF = 5.0
F_, T_, B_ = 16, 2, 8
E_RTOL = 1e-5            # energy, relative
F_ATOL = 1e-4            # forces, eV/Ang elementwise
GRAD_RTOL = 1e-4         # parameter gradients, per leaf (``grads_close``)
PAD_ATOMS = 4
MODELS = {"painn": (JPaiNN, PaiNN), "schnet": (JSchNet, SchNet),
          "so3net": (JSO3net, SO3net),
          "field_schnet": (JFieldSchNet, FieldSchNet)}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jcellblock, "IMPL", "xla")


def _box():
    R, cell = fcc_argon(3, jitter=0.2, seed=1)
    return {P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
            P.pbc: np.ones(3, bool)}


def _molecule(rng, n, d_min=1.0):
    """n atoms (random Z in 1-8) placed one by one in a 4 A cube, each at
    least ``d_min`` A from the others, as in a molecule."""
    R = [rng.rand(3) * 4.0]
    while len(R) < n:
        r = rng.rand(3) * 4.0
        if np.linalg.norm(np.asarray(R) - r, axis=1).min() >= d_min:
            R.append(r)
    return {P.Z: rng.randint(1, 9, n).astype(np.int64), P.R: np.asarray(R),
            P.cell: np.zeros((3, 3)), P.pbc: np.zeros(3, bool)}


def _samples():
    """Neighbor-listed samples: three molecules of 5, 8 and 12 atoms and
    the 108-atom argon box."""
    rng = np.random.RandomState(2)
    raw = [_molecule(rng, n) for n in (5, 8, 12)] + [_box()]
    return [NeighborListTransform(CUTOFF)(s) for s in raw]


@functools.lru_cache(maxsize=None)
def _batch(layout):
    """(numpy batch, real atoms, real molecules) on a layout."""
    samples = _samples()
    A = sum(len(s[P.Z]) for s in samples)
    n_pairs = sum(len(s[P.idx_i]) for s in samples)
    K = max(int(np.bincount(s[P.idx_i]).max()) for s in samples) + 2
    spec = PaddingSpec(A + PAD_ATOMS, n_pairs + 8, len(samples) + 1,
                       n_neighbors=K if layout == "dense" else 0)
    b = collate(samples, spec)
    if layout == "dense":
        b.update({P.idx_i: np.zeros(1, np.int32),
                  P.idx_j: np.zeros(1, np.int32),
                  P.offsets: np.full((1, 3), 1e3, np.float32),
                  P.pair_mask: np.zeros(1, np.float32)})
    return b, A, len(samples)


def _potentials(model, forces=True, **kw):
    """(JAX potential, port potential) of a model at F = 16, 2
    interactions, 8 basis functions."""
    J, T = MODELS[model]
    common = dict(n_atom_basis=F_, n_interactions=T_, n_rbf=B_,
                  cutoff=CUTOFF)
    extra = dict(lmax=2) if model == "so3net" else {}
    jkw = {k: v[0] for k, v in kw.items()}
    tkw = {k: v[1] for k, v in kw.items()}
    jpot = JNNP(representation=J(**common, **extra, **jkw),
                input_modules=[JPairwiseDistances()],
                output_modules=[JAtomwise(output_key=P.energy)]
                + ([JForces()] if forces else []))
    pot = NeuralNetworkPotential(
        T(**common, **extra, **tkw),
        [Atomwise(n_in=F_)] + ([Forces()] if forces else []),
        input_modules=[PairwiseDistances()])
    return jpot, pot


@functools.lru_cache(maxsize=None)
def _tree(model, bessel=False):
    """The model's perturbed flax parameters, from the box's flat batch."""
    kw = _bessel() if bessel else {}
    jpot, _ = _potentials(model, **kw)
    b, _, _ = _batch("flat")
    return _perturbed(jax.jit(jpot.init)(jax.random.PRNGKey(0), b), seed=1)


def _bessel():
    return {"radial_basis": (JBesselRBF(n_rbf=B_, cutoff=CUTOFF),
                             tnn.BesselRBF(B_, CUTOFF))}


def _port_outputs(model, layout, **kw):
    b, A, M = _batch(layout)
    _, pot = _potentials(model, **kw)
    pot.load_state_dict(params_from_jax(_tree(model, bool(kw))))
    out = pot.requires_grad_(False)(
        {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()})
    return (out[TP.energy].numpy()[:M], out[TP.forces].numpy()[:A])


@functools.lru_cache(maxsize=None)
def _jax_outputs(model, layout, **kw):
    b, A, M = _batch(layout)
    jpot, _ = _potentials(model, **kw)
    out = jax.jit(jpot.apply)(_tree(model, bool(kw)), b)
    return np.asarray(out[P.energy])[:M], np.asarray(out[P.forces])[:A]


def _close(got, want):
    (E, F), (E_ref, F_ref) = got, want
    np.testing.assert_allclose(E, E_ref, rtol=E_RTOL)
    np.testing.assert_allclose(F, F_ref, rtol=0, atol=F_ATOL)
    assert np.abs(F_ref).max() > 1e-3      # forces worth comparing


@pytest.mark.parametrize("layout", ["flat", "dense"])
@pytest.mark.parametrize("model", list(MODELS))
def test_representation_matches_jax(model, layout):
    """Energy (rtol 1e-5) and forces (1e-4 eV/Ang) of each representation
    on each layout against the JAX package on the same batch."""
    _close(_port_outputs(model, layout), _jax_outputs(model, layout))


@pytest.mark.parametrize("model", list(MODELS))
def test_flat_equals_dense(model):
    """The port's flat and dense layouts give one energy and one set of
    forces (``tests/test_dense_layout.py:39-90``)."""
    _close(_port_outputs(model, "dense"), _port_outputs(model, "flat"))


def test_padded_dense_slots_keep_gradients_finite():
    """A dense list whose padded slots point to the last atom with offset
    0, as the MD neighbor list pads: that atom's own padded slots have
    Rij = 0, where the safe norm keeps the forces and the parameter
    gradients finite (0 * NaN would be NaN)."""
    b, A, M = _batch("dense")
    b = dict(b)
    last = b[P.nbh_idx].shape[0] - 1
    pad = b[P.nbh_mask] == 0
    b[P.nbh_idx] = np.where(pad, last, b[P.nbh_idx])
    b[P.nbh_offsets] = np.where(pad[..., None], 0.0,
                                b[P.nbh_offsets]).astype(np.float32)
    b[P.R] = b[P.R].copy()
    b[P.R][A:] = b[P.R][0]        # padding atoms inside the cutoff
    inputs = {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}
    for model in MODELS:
        params = params_from_jax(_tree(model))
        _, pot = _potentials(model)
        pot.load_state_dict(params)
        out = pot.requires_grad_(False)(dict(inputs))
        assert torch.isfinite(out[TP.forces]).all(), model
        np.testing.assert_allclose(out[TP.energy].numpy()[:M],
                                   _port_outputs(model, "dense")[0],
                                   rtol=E_RTOL)
        _, pot = _potentials(model, forces=False)
        pot.load_state_dict(params)
        leaves = list(pot.parameters())
        grads = torch.autograd.grad(pot(dict(inputs))[TP.energy][:M].sum(),
                                    leaves, allow_unused=True)
        assert all(torch.isfinite(g).all() for g in grads if g is not None)


@pytest.mark.parametrize("model", ["painn", "schnet"])
def test_parameter_gradients_match_jax_on_flat(model):
    """The energy's gradient with respect to every parameter on the box's
    flat batch, per leaf against ``jax.grad`` (``grads_close``)."""
    b, _, M = _batch("flat")
    jpot, pot = _potentials(model, forces=False)
    tree = _tree(model)
    want = params_from_jax(jax.jit(jax.grad(
        lambda p: jpot.apply(p, b)[P.energy][:M].sum()))(tree))
    pot.load_state_dict(params_from_jax(tree))
    names, leaves = zip(*pot.named_parameters())
    out = pot({k: torch.as_tensor(np.asarray(v)) for k, v in b.items()})
    grads = torch.autograd.grad(out[TP.energy][:M].sum(), leaves)
    assert set(names) == set(want)
    worst, err = grads_close(dict(zip(names, grads)), want, GRAD_RTOL)
    assert err <= GRAD_RTOL, (worst, err)


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_schnet_with_a_bessel_basis_matches_jax(layout):
    """SchNet takes any radial basis off the column layout."""
    _close(_port_outputs("schnet", layout, **_bessel()),
           _jax_outputs("schnet", layout, **_bessel()))


@pytest.mark.parametrize("model", ["schnet", "so3net"])
def test_cellblock_atom_matches_jax(model):
    """SchNet and SO3net on the 27-cell atom layout through the calculator
    (``neighbor_list="cellblock_atom"``: displacements from the K16/K17
    twins, then the dense branch with a plain gather) on the argon box,
    against the JAX package's flat batch there."""
    _, pot = _potentials(model)
    calc = SchNetPackCalculator(pot, params_from_jax(_tree(model)),
                                cutoff=CUTOFF, cutoff_shell=0.3,
                                neighbor_list="cellblock_atom")
    s = load_molecules([_box()], device="cpu")
    state = calc.init_state(s)
    assert TP.cell_qidx in calc.model_inputs(s, state)
    s = calc.calculate(s, state)
    E_ref, F_ref = _jax_outputs(model, "flat")
    n_box = len(_box()[P.Z])
    _close((s.energy.numpy()[0] / calc.energy_conversion,
            s.forces.numpy()[0] / calc.force_conversion),
           (E_ref[-1:], F_ref[-n_box:]))
