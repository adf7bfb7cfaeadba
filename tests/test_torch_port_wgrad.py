"""PyTorch port, parameter gradients on the column layout: the weight
cotangents of K4's and K10's twins against the JAX XLA oracles
(``painn_mixing_xla``, ``_cfconv_xla``), and the gradient of the energy with
respect to every parameter of a small PaiNN (both message forms) and SchNet
on column inputs against ``jax.grad`` of the JAX potential (flat pair
list, IMPL "xla"), leaf by leaf.  The models carry the energy output only:
neither package takes a second derivative through the column kernels.
The CUDA kernels' wgrad instances are held against these twins in
``test_torch_port_kernels.py``; the full-size fixtures
(``scripts/make_port_reference_grad.py``) are checked at the end.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.atomistic import Atomwise as JAtomwise
from schnetpack_tpu.atomistic import PairwiseDistances
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.ops import colblock as jcb
from schnetpack_tpu.ops import colblock_geo as jgeo
from schnetpack_tpu.ops.painn_mixing import painn_mixing_xla
from schnetpack_tpu.ops.schnet_columns import _cfconv_xla
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu.representation import SchNet as JSchNet
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic import Atomwise
from schnetpack_tpu_torch.convert import params_from_jax
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.ops import painn_mixing as mix
from schnetpack_tpu_torch.ops import schnet_columns as cf
from schnetpack_tpu_torch.ops.colblock import ColRefs
from schnetpack_tpu_torch.representation import PaiNN, SchNet
from torch_port_cases import (
    MIX_ATOL, MIX_INPUTS, MIX_RTOL, cfconv_case, grads_close, mixing_case,
)
from test_torch_port_model import ROOT, fcc_box, port_inputs
from test_torch_port_schnet import _jax_batch

CUTOFF = 5.0
# weight cotangents of the twins: f32 sums over the rows / edges in another
# order than XLA's, held normwise: ||g - w|| <= W_RTOL ||w||
W_RTOL = 1e-5
# energy gradient, per leaf: ||g - g_jax|| <= GRAD_RTOL ||g_jax|| (leaves
# under 1e-3 of the largest norm against GRAD_RTOL * 1e-3 of it)
GRAD_RTOL = 1e-4
FIXTURES = {name: os.path.join(ROOT, "tests", "data",
                               f"port_ref_{name}_grad_argon.npz")
            for name in ("painn", "schnet")}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("act", ["ssp", "silu"])
def test_mixing_twin_weight_cotangents_match_jax(act):
    """K4's twin with ``wgrad``: every cotangent of the mixing block against
    ``jax.vjp`` of ``painn_mixing_xla``; the op on CPU tensors carries the
    same through autograd."""
    c = mixing_case(A=37)
    args = [jnp.asarray(c[k]) for k in MIX_INPUTS]
    _, vjp = jax.vjp(lambda *a: painn_mixing_xla(*a, 1e-8, act), *args)
    want = vjp((jnp.asarray(c["gq"]), jnp.asarray(c["gmu"])))
    t = [torch.tensor(c[k]) for k in MIX_INPUTS]
    cots = (torch.tensor(c["gq"]), torch.tensor(c["gmu"]))
    got = mix.painn_mixing_bwd_plain(*t, 1e-8, act, *cots, wgrad=True)
    assert len(got) == 7
    for name, g, w in zip(("q", "mu"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), MIX_RTOL,
                                   MIX_ATOL, err_msg=name)
    for name, g, w in zip(MIX_INPUTS[4:], got[2:], want[4:]):
        _assert_normwise(g, w, name)
    ins = [a.clone().requires_grad_(True) for a in t]
    out = mix.painn_mixing_fused(*ins, 1e-8, act)
    grads = torch.autograd.grad(out, ins, cots)
    for name, g, w in zip(MIX_INPUTS, grads, want):
        _assert_normwise(g, w, name)
    assert len(mix.painn_mixing_bwd_plain(*t, 1e-8, act, *cots)) == 2


def _assert_normwise(got, want, name):
    w = np.asarray(want, np.float64)
    err = np.linalg.norm(got.detach().double().numpy() - w)
    assert err <= W_RTOL * np.linalg.norm(w), (name, err, np.linalg.norm(w))


@pytest.mark.parametrize("seed", [3, 21])
def test_cfconv_twin_weight_cotangents_match_jax(seed):
    """K10's twin: the filter-weight cotangents gW1, gb1, gW2, gb2 against
    ``jax.vjp`` of ``_cfconv_xla``, and through the op (CPU twins)."""
    c = cfconv_case(seed=seed)
    jrefs = jcb.ColRefs.from_layout(c["lay"])
    geo = jgeo.split_geo(jnp.asarray(c["geo"]), jrefs.ksizes)
    ws = [jnp.asarray(c[k]) for k in ("W1", "b1", "W2", "b2")]
    _, vjp = jax.vjp(lambda *w: _cfconv_xla(jnp.asarray(c["h"]), geo, *w,
                                            jrefs), *ws)
    want = vjp(jnp.asarray(c["g"]))
    refs = ColRefs.from_layout(c["lay"])
    names = ("h", "geo", "W1", "b1", "W2", "b2")
    t = [torch.tensor(c[k]) for k in names]
    got = cf.cf_bwd_plain(*t, refs, torch.tensor(c["g"]))[2:]
    ins = t[:2] + [a.clone().requires_grad_(True) for a in t[2:]]
    out = cf.schnet_cfconv_columns(*ins, refs)
    op_grads = torch.autograd.grad(out, ins[2:], torch.tensor(c["g"]))
    for name, g, og, w in zip(names[2:], got, op_grads, want):
        _assert_normwise(g, w, name)
        torch.testing.assert_close(og, g, rtol=0, atol=0)


# ------------------------------------------------------------------ model
def _jax_energy_model(rep_name, F, T, B):
    rep = (JPaiNN(n_atom_basis=F, n_interactions=T, n_rbf=B, cutoff=CUTOFF)
           if rep_name == "painn" else
           JSchNet(n_atom_basis=F, n_interactions=T, n_rbf=B, cutoff=CUTOFF))
    return JNNP(representation=rep, input_modules=[PairwiseDistances()],
                output_modules=[JAtomwise(output_key=P.energy)])


def port_energy_model(rep_name, F, T, B, fuse="full"):
    """The port's potential with the energy output only (no Forces: a
    parameter gradient beside forces would need a second derivative)."""
    rep = (PaiNN(n_atom_basis=F, n_interactions=T, n_rbf=B, cutoff=CUTOFF,
                 fuse=fuse)
           if rep_name == "painn" else
           SchNet(n_atom_basis=F, n_interactions=T, n_rbf=B, cutoff=CUTOFF))
    return NeuralNetworkPotential(rep, [Atomwise(n_in=F)])


def port_energy_grads(pot, inputs):
    """(energy, {name: dE/dparam}) of the port's potential."""
    names, params = zip(*pot.named_parameters())
    E = pot(inputs)[TP.energy][0]
    return float(E.detach()), dict(zip(names, torch.autograd.grad(E, params)))


def jax_energy_grads(model, tree, batch):
    def energy(p):
        return model.apply(p, batch)[P.energy][0]

    E, g = jax.value_and_grad(energy)(tree)
    return float(E), params_from_jax(jax.device_get(g))


@pytest.mark.parametrize("rep_name,fuse", [("painn", "full"),
                                           ("painn", "hybrid"),
                                           ("schnet", None)])
def test_energy_parameter_gradient_matches_jax(rep_name, fuse):
    """F = 32, 2 interactions, B = 8, seeded flax init, on the jittered
    fcc_box(4) (column grid 3 x 3): the port on column inputs (CPU twins)
    against ``jax.grad`` of the JAX potential on the flat pair list."""
    rng = np.random.RandomState(4)
    R, cell = fcc_box(4)
    R = R + rng.uniform(-0.2, 0.2, R.shape)
    jmodel = _jax_energy_model(rep_name, 32, 2, 8)
    batch = _jax_batch(R, cell)
    tree = jax.device_get(jmodel.init(jax.random.PRNGKey(1), batch))
    E_ref, g_ref = jax_energy_grads(jmodel, tree, batch)
    _, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    pot = port_energy_model(rep_name, 32, 2, 8, fuse or "full")
    pot.load_state_dict(params_from_jax(tree))
    E, grads = port_energy_grads(pot, inputs)
    np.testing.assert_allclose(E, E_ref, rtol=1e-5)
    assert set(grads) == set(g_ref)
    worst = grads_close(grads, g_ref, GRAD_RTOL)
    assert worst[1] <= GRAD_RTOL, worst


@pytest.mark.parametrize("name", ["painn", "schnet"])
def test_gradient_fixture_is_the_bench_box(name):
    """The full-size fixtures hold the jittered bench box, a finite energy
    and a finite, nonzero gradient for every parameter of the port's
    PaiNN-128x3 / SchNet-128x3 (``scripts/make_port_reference_grad.py``)."""
    ref = np.load(FIXTURES[name])
    base = np.load(os.path.join(ROOT, "tests", "data",
                                f"port_ref_{name}_argon.npz"))
    np.testing.assert_array_equal(ref["R"], base["R"])
    np.testing.assert_allclose(float(ref["energy"]), float(base["energy"]),
                               rtol=1e-5)
    pot = port_energy_model(name, 128, 3, 20)
    state = pot.state_dict()
    keys = [k[len("grad/"):] for k in ref.files if k.startswith("grad/")]
    assert set(keys) == set(state)
    for k in keys:
        g = ref[f"grad/{k}"]
        assert g.shape == tuple(state[k].shape), k
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
