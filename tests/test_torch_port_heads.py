"""PyTorch port, the output heads: the gated equivariant block, Atomwise's
options (``n_out``, ``aggregation_mode`` sum/avg/None,
``per_atom_output_key``), ``DipoleMoment`` (latent charges with and
without the total-charge correction, hidden widths, the vector
representation, the magnitude), ``Polarizability`` and ``Aggregation``
against the JAX package on the same batch, their parameter gradients,
the advertised outputs, and the heads' parameters through
``convert.params_to_jax`` and back.

The batch is the JAX collate of three molecules of 5, 8 and 12 atoms (and
two padding atoms) with a total charge per molecule; the representation
is PaiNN-16x2 on the flat layout.  Weights come from the flax init with
every zero-initialised leaf perturbed from a numpy seed and are carried
across by ``convert.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import atomistic as ja
from schnetpack_tpu import properties as P
from schnetpack_tpu.data.loader import PaddingSpec, collate
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.nn.equivariant import GatedEquivariantBlock as JGated
from schnetpack_tpu.ops import cellblock as jcellblock
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu.transform.neighborlist import NeighborListTransform
from schnetpack_tpu_torch import atomistic as ta
from schnetpack_tpu_torch.convert import _tree, params_from_jax, params_to_jax
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.nn import GatedEquivariantBlock
from schnetpack_tpu_torch.representation import PaiNN
from test_torch_port_layouts import _molecule
from test_torch_port_model_options import _perturbed
from torch_port_cases import grads_close

CUTOFF = 5.0
F_, T_, B_ = 16, 2, 8
# outputs: f32 sums in another order (relative, with an absolute floor
# for elements near zero)
OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4     # parameter gradients, per leaf (``grads_close``)
# a leaf whose gradient is zero by an invariance: both sides' norms under
# this share of the largest leaf's (f32 roundoff)
ZERO_GRAD_RTOL = 1e-5
#: leaves with a zero gradient: the corrected charges do not depend on
#: the charge network's last bias (a uniform shift is corrected away)
ZERO_GRAD = {"dipole_charges": ("output_modules.0.charge_net.dense_1.bias",)}

#: head cases: (JAX heads, port heads)
HEADS = {
    "atomwise_nout3_avg": (
        lambda: [ja.Atomwise(output_key="y", n_out=3,
                             aggregation_mode="avg")],
        lambda: [ta.Atomwise(F_, output_key="y", n_out=3,
                             aggregation_mode="avg")]),
    "atomwise_per_atom": (
        lambda: [ja.Atomwise(output_key="y", aggregation_mode=None)],
        lambda: [ta.Atomwise(F_, output_key="y", aggregation_mode=None)]),
    "atomwise_per_atom_key": (
        lambda: [ja.Atomwise(output_key="y", n_layers=3,
                             per_atom_output_key="y_atom")],
        lambda: [ta.Atomwise(F_, output_key="y", n_layers=3,
                             per_atom_output_key="y_atom")]),
    "dipole_charges": (
        lambda: [ja.DipoleMoment()], lambda: [ta.DipoleMoment(F_)]),
    "dipole_hidden_uncorrected": (
        lambda: [ja.DipoleMoment(n_hidden=(12, 6), correct_charges=False)],
        lambda: [ta.DipoleMoment(F_, n_hidden=(12, 6),
                                 correct_charges=False)]),
    "dipole_vector_magnitude": (
        lambda: [ja.DipoleMoment(use_vector_representation=True,
                                 predict_magnitude=True)],
        lambda: [ta.DipoleMoment(F_, use_vector_representation=True,
                                 predict_magnitude=True)]),
    "polarizability": (
        lambda: [ja.Polarizability(n_layers=3)],
        lambda: [ta.Polarizability(F_, n_layers=3)]),
    "aggregation": (
        lambda: [ja.Atomwise(output_key="e1"), ja.Atomwise(output_key="e2"),
                 ja.Aggregation(keys=("e1", "e2"), output_key=P.energy)],
        lambda: [ta.Atomwise(F_, output_key="e1"),
                 ta.Atomwise(F_, output_key="e2"),
                 ta.Aggregation(["e1", "e2"], output_key=P.energy)]),
}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jcellblock, "IMPL", "xla")


def molecules(sizes=(5, 8, 12), seed=2):
    """Neighbor-listed molecules of ``sizes`` atoms (Z in 1-8)."""
    rng = np.random.RandomState(seed)
    return [NeighborListTransform(CUTOFF)(_molecule(rng, n)) for n in sizes]


@functools.lru_cache(maxsize=None)
def batch(sizes=(5, 8, 12), pad_atoms=2):
    """(numpy flat batch with a total charge per molecule, real atoms,
    real molecules)."""
    samples = molecules(sizes)
    A = sum(len(s[P.Z]) for s in samples)
    n_pairs = sum(len(s[P.idx_i]) for s in samples)
    b = collate(samples, PaddingSpec(A + pad_atoms, n_pairs + 8,
                                     len(samples) + 1))
    b[P.total_charge] = np.array([1.0, -1.0, 0.0, 0.0][:len(samples) + 1],
                                 np.float32)
    return b, A, len(samples)


def as_torch(b):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}


def painn_pair(jheads, theads):
    """(JAX potential, port potential) of PaiNN-16x2 and the heads."""
    common = dict(n_atom_basis=F_, n_interactions=T_, n_rbf=B_,
                  cutoff=CUTOFF)
    jpot = JNNP(representation=JPaiNN(**common),
                input_modules=[ja.PairwiseDistances()],
                output_modules=jheads)
    pot = NeuralNetworkPotential(PaiNN(**common), theads,
                                 input_modules=[ta.PairwiseDistances()])
    return jpot, pot


def init_tree(jpot, b, seed=1):
    """The flax init of ``jpot`` on ``b``, zero leaves perturbed."""
    return _perturbed(jax.jit(jpot.init)(jax.random.PRNGKey(0), b), seed)


def close(got, want, rtol=OUT_RTOL, atol=OUT_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


@functools.lru_cache(maxsize=None)
def _case(name):
    jheads, theads = HEADS[name]
    b, A, M = batch()
    jpot, pot = painn_pair(jheads(), theads())
    tree = init_tree(jpot, b)
    pot.load_state_dict(params_from_jax(tree))
    return jpot, pot, tree, b, A, M


def _rows(key, v, A, M):
    """The real rows of an output: per molecule or per atom."""
    return v[:M] if v.shape[0] == M + 1 else v[:A]


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_matches_jax(name):
    """Every advertised output, and the parameter gradient of the sum of
    the outputs' squares, against the JAX package."""
    jpot, pot, tree, b, A, M = _case(name)
    keys = list(pot.model_outputs)
    assert keys == jpot.model_outputs

    def jloss(p):
        out = jpot.apply(p, b)
        return sum(jnp.sum(jnp.asarray(_rows(k, out[k], A, M)) ** 2)
                   for k in keys), out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        tree)
    out = pot(as_torch(b))
    loss = sum((_rows(k, out[k], A, M) ** 2).sum() for k in keys)
    grads = torch.autograd.grad(loss, list(pot.parameters()))
    for k in keys:
        close(_rows(k, out[k].detach(), A, M), _rows(k, jout[k], A, M))
        assert np.abs(_rows(k, jout[k], A, M)).max() > 1e-3, k
    named = dict(zip([n for n, _ in pot.named_parameters()], grads))
    want = params_from_jax(jax.device_get(jgrads))
    largest = max(float(w.norm()) for w in want.values())
    for k in ZERO_GRAD.get(name, ()):
        assert float(named[k].norm()) <= ZERO_GRAD_RTOL * largest, k
        assert float(want.pop(k).norm()) <= ZERO_GRAD_RTOL * largest, k
    worst, err = grads_close(named, want, GRAD_RTOL)
    assert err <= GRAD_RTOL, (worst, err)


def test_charges_are_corrected_to_the_total_charge():
    _, pot, _, b, A, M = _case("dipole_charges")
    out = pot(as_torch(b))
    q = out[P.partial_charges].detach().numpy()
    idx_m = np.asarray(b[P.idx_m])[:A]
    sums = np.bincount(idx_m, q[:A], minlength=M)
    np.testing.assert_allclose(sums, b[P.total_charge][:M], atol=1e-5)


def test_gated_block_matches_flax():
    """One block (n_sout 5, n_vout 7, hidden 9, ssp on the scalars) and
    its input cotangents against flax's ``GatedEquivariantBlock``."""
    from schnetpack_tpu.ops.activations import shifted_softplus

    rng = np.random.RandomState(4)
    s = rng.randn(11, 6).astype(np.float32)
    v = rng.randn(11, 3, 4).astype(np.float32)
    g_s, g_v = rng.randn(11, 5), rng.randn(11, 3, 7)
    jblk = JGated(n_sout=5, n_vout=7, n_hidden=9,
                  sactivation=shifted_softplus)
    params = jblk.init(jax.random.PRNGKey(3), s, v)
    (js, jv), vjp = jax.vjp(lambda a, c: jblk.apply(params, a, c), s, v)
    jgs, jgv = vjp((jnp.asarray(g_s, jnp.float32),
                    jnp.asarray(g_v, jnp.float32)))
    sd = {}
    _tree("blk", jax.device_get(params["params"]), sd)
    blk = GatedEquivariantBlock(6, 4, 5, 7, 9,
                                sactivation=ta.atomwise._activation("ssp"))
    blk.load_state_dict({k[4:]: torch.as_tensor(np.asarray(v))
                         for k, v in sd.items()})
    ts, tv = torch.tensor(s, requires_grad=True), torch.tensor(
        v, requires_grad=True)
    os_, ov = blk(ts, tv)
    gs, gv = torch.autograd.grad(
        (os_ * torch.tensor(g_s, dtype=torch.float32)).sum()
        + (ov * torch.tensor(g_v, dtype=torch.float32)).sum(), (ts, tv))
    for got, want in ((os_, js), (ov, jv), (gs, jgs), (gv, jgv)):
        close(got.detach(), want, rtol=1e-5, atol=1e-6)


def test_params_to_jax_round_trips_every_head():
    """``params_to_jax`` of a potential with every head gives the flax
    tree leaf for leaf, and ``params_from_jax`` of that the state dict."""
    jheads = [ja.Atomwise(output_key=P.energy, n_out=2),
              ja.DipoleMoment(use_vector_representation=True),
              ja.DipoleMoment(dipole_key="d2", charges_key="q2"),
              ja.Polarizability(), ja.ZBLRepulsionEnergy()]
    theads = [ta.Atomwise(F_, output_key=P.energy, n_out=2),
              ta.DipoleMoment(F_, use_vector_representation=True),
              ta.DipoleMoment(F_, dipole_key="d2", charges_key="q2"),
              ta.Polarizability(F_), ta.ZBLRepulsionEnergy()]
    b, _, _ = batch()
    jpot, pot = painn_pair(jheads, theads)
    tree = init_tree(jpot, b)
    pot.load_state_dict(params_from_jax(tree))
    back = params_to_jax(pot)

    def leaves(node, path=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{path}/{k}")
            else:
                yield f"{path}/{k}", np.asarray(v)
    want = dict(leaves(tree["params"]))
    got = dict(leaves(back["params"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sd = params_from_jax(back)
    for k, v in pot.state_dict().items():
        assert torch.equal(sd[k], v), k
