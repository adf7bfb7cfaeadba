"""PyTorch port at the widths the tuned card kernels do not take.

The card runs general instances of the message, mixing and cfconv kernels
for every F and B the tuned ones do not take (``csrc/*_gen.cu``); on the
CPU the ops run the same twins at every width.  Here: whole PaiNN-30x3
(both message forms) and SchNet-30x3 on the column layout against the JAX
package at 256 atoms, SchNet-64x3 with 300 Gaussians (the parameter
conversion at B = 300), the width fixtures of ``chip_smoke.py``'s phase 17
and the models and launch tables it builds from them, the wrappers'
dispatch between the tuned and general instances at every width, and K3's
padded weights (cached per parameter version).
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.atomistic import Atomwise as JAtomwise
from schnetpack_tpu.atomistic import Forces as JForces
from schnetpack_tpu.atomistic import PairwiseDistances
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic import Atomwise, Forces
from schnetpack_tpu_torch.convert import params_from_jax
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.ops import colblock_message as msg
from schnetpack_tpu_torch.ops import painn_mixing as mix
from schnetpack_tpu_torch.ops import schnet_columns as cf
from schnetpack_tpu_torch.representation import PaiNN, SchNet
from test_torch_port_model import ROOT, fcc_box, port_inputs
from test_torch_port_schnet import (
    CUTOFF, E_RTOL, F_SCALED_ATOL, _compare_with_jax, _jax_batch,
    _jax_potential,
)
from torch_port_cases import MIX_INPUTS, mixing_case

sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

#: the widths and bases the acceptance names, each taken by some instance
WIDTHS = (1, 30, 50, 96, 288, 353, 512)
BASES = (20, 31, 50, 300)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _box(seed=0, jitter=0.15):
    rng = np.random.RandomState(seed)
    R, cell = fcc_box(4)
    return R + rng.uniform(-jitter, jitter, R.shape), cell


def _jax_painn(F, B):
    return JNNP(representation=JPaiNN(n_atom_basis=F, n_interactions=3,
                                      n_rbf=B, cutoff=CUTOFF),
                input_modules=[PairwiseDistances()],
                output_modules=[JAtomwise(output_key=P.energy), JForces()])


@pytest.mark.parametrize("fuse", ["full", "hybrid"])
def test_painn_w30_matches_jax(fuse):
    """PaiNN-30x3 (the tutorials' width, 20 Gaussians) from the JAX
    model's own init on the column layout of 256 jittered argon atoms,
    against the JAX package's energy and forces."""
    R, cell = _box()
    batch = _jax_batch(R, cell)
    pot = _jax_painn(30, 20)
    tree = jax.device_get(pot.init(jax.random.PRNGKey(3), batch))
    out = pot.apply(tree, batch)
    E_ref = float(np.asarray(out[P.energy])[0])
    F_ref = np.asarray(out[P.forces])[:len(R)]
    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    assert lay.dims[0] >= 3 and lay.dims[1] >= 3
    port = NeuralNetworkPotential(
        PaiNN(n_atom_basis=30, n_interactions=3, n_rbf=20, cutoff=CUTOFF,
              fuse=fuse), [Atomwise(n_in=30), Forces()])
    port.load_state_dict(params_from_jax(tree))
    got = port.requires_grad_(False)(inputs)
    np.testing.assert_allclose(float(got[TP.energy][0]), E_ref, rtol=E_RTOL)
    Fp = got[TP.forces].numpy()[lay.rank]
    scale = np.abs(F_ref).max()
    assert scale > 0
    assert np.abs(Fp - F_ref).max() / scale <= F_SCALED_ATOL


@pytest.mark.parametrize("F,B", [(30, 20), (64, 300)])
def test_schnet_widths_match_jax(F, B):
    """SchNet-30x3 and SchNet-64x3 with the SchNet paper's 300 Gaussians
    from the JAX model's own init on the column layout, against the JAX
    package: ``params_from_jax`` carries both across."""
    R, cell = _box(seed=1)
    tree = _jax_potential(F, 3, B).init(jax.random.PRNGKey(5),
                                        _jax_batch(R, cell))
    _compare_with_jax(R, cell, jax.device_get(tree), F, 3, B)


@pytest.mark.parametrize("model,F,B", [("painn", 30, 20),
                                       ("schnet", 30, 20),
                                       ("schnet", 64, 300)])
def test_params_from_jax_takes_any_width(model, F, B):
    """Every parameter of the port's model at (F, B) comes from the JAX
    init's tree, at its shape."""
    R, cell = _box()
    if model == "painn":
        jpot = _jax_painn(F, B)
        rep = PaiNN(n_atom_basis=F, n_interactions=3, n_rbf=B, cutoff=CUTOFF)
    else:
        jpot = _jax_potential(F, 3, B)
        rep = SchNet(n_atom_basis=F, n_interactions=3, n_rbf=B,
                     cutoff=CUTOFF)
    tree = jax.device_get(jpot.init(jax.random.PRNGKey(0),
                                    _jax_batch(R, cell)))
    params = params_from_jax(tree)
    state = NeuralNetworkPotential(rep, [Atomwise(n_in=F)]).state_dict()
    assert set(params) == set(state)
    for k, v in params.items():
        assert v.shape == state[k].shape, k


@pytest.mark.parametrize("name", sorted(cs.WIDTH_REFERENCE))
def test_width_fixture_is_the_bench_box(name):
    """Each phase-17 fixture holds the jittered 10,976-atom bench box, a
    finite force field whose net force vanishes, and the model's seeded
    parameter tree at its width and basis."""
    ref = np.load(cs.WIDTH_REFERENCE[name])
    R0, cell = fcc_box(14)
    assert ref["R"].shape == (10976, 3) and ref["forces"].shape == (10976, 3)
    np.testing.assert_allclose(ref["cell"], cell)
    assert np.abs(ref["R"] - R0).max() <= float(ref["jitter"]) + 1e-5
    assert np.isfinite(ref["energy"]) and np.isfinite(ref["forces"]).all()
    assert np.abs(ref["forces"].sum(0)).max() < 1e-2
    tree, F, B = cs.width_tree(name)
    assert (F, B) == {"painn_w30": (30, 20), "schnet_w30": (30, 20),
                      "schnet_b300": (64, 300)}[name]
    assert "representation" in tree["params"]


@pytest.mark.parametrize("path,name", [
    ("full", "painn_w30"), ("hybrid", "painn_w30"),
    ("painn_trbf", "painn_w30"), ("painn_cell", "painn_w30"),
    ("painn_slab", "painn_w30"), ("schnet", "schnet_w30"),
    ("schnet", "schnet_b300")])
def test_width_potentials_load_their_fixture(path, name):
    """Phase 17's models load their fixture's parameters, every one of
    them (strict), at the fixture's width."""
    pot, params = cs.width_potential(path, name)
    pot.load_state_dict(params)
    _, F, _ = cs.width_tree(name)
    assert pot.representation.n_atom_basis == F


@pytest.mark.parametrize("name,path", [("painn_w30", "hybrid"),
                                       ("schnet_w30", "schnet")])
def test_width_fixture_forces_on_the_column_layout(name, path):
    """The port's ``SchNetPackCalculator`` on the column layout (the twins
    of the general instances on the CPU) against the phase-17 fixture on
    the full bench box, at phase 4's gates (force rms 1e-4 eV/Ang, energy
    1e-5 relative)."""
    from schnetpack_tpu_torch.md import load_molecules

    ref = np.load(cs.WIDTH_REFERENCE[name])
    calc = cs.calculator(*cs.width_potential(path, name))
    system = load_molecules([cs.molecule(ref["R"].astype(np.float64),
                                         ref["cell"])], device="cpu")
    system = calc.calculate(system, calc.init_state(system))
    F = (system.forces[0] / calc.force_conversion).numpy()
    E = float(system.energy[0, 0]) / calc.energy_conversion
    assert np.sqrt(np.mean((F - ref["forces"]) ** 2)) <= cs.FORCE_RMS_TOL
    np.testing.assert_allclose(E, float(ref["energy"]), rtol=cs.ENERGY_RTOL)


def test_gen_per_step_names_the_general_instances():
    """At F = 30 phase 17 expects the general message, mixing-backward
    and cfconv instances and the tuned K3 (padded), K5, K8 and gathers; at
    the bench width the tuned table itself; at B = 300 SchNet-64's cfconv
    runs the general instance; at F = 384 (the run that drives it) K3's
    general instance."""
    assert cs.gen_per_step(cs.PER_STEP["full"], 30, 20) == {
        "msg_fwd_gen": 3, "msg_bwd_gen": 3, "mix_fwd": 3, "mix_bwd_gen": 3}
    assert cs.gen_per_step(cs.PER_STEP["painn_cell"], 30, 20) == {
        "cell_gather_fwd": 1, "cell_gather_bwd": 1, "cell_msg_fwd_gen": 3,
        "cell_msg_bwd_gen": 3, "mix_fwd": 3, "mix_bwd_gen": 3}
    for path in ("hybrid", "full", "schnet", "painn_slab"):
        assert cs.gen_per_step(cs.PER_STEP[path], 128, 20) == \
            cs.PER_STEP[path]
    assert cs.gen_per_step(cs.PER_STEP["schnet"], 64, 300) == {
        "geo_fwd_raw": 1, "cf_fwd_gen": 3, "cf_bwd_gen": 3, "geo_bwd": 1}
    assert cs.mode_counts(cs.gen_per_step(cs.PER_STEP["full"], 30, 20),
                          "bf16")["msg_bwd_gen_bf16"] == 3
    assert cs.gen_per_step(cs.PER_STEP["full"], cs.WIDTH_K3, 20) == {
        "msg_fwd_gen": 3, "msg_bwd_gen": 3, "mix_fwd_gen": 3,
        "mix_bwd_gen": 3}
    pot, params = cs.wide_potential(0)
    pot.load_state_dict(params)
    assert pot.representation.n_atom_basis > mix.FWD_MAX_F


@pytest.mark.parametrize("B", BASES)
@pytest.mark.parametrize("F", WIDTHS)
def test_every_width_has_an_instance(F, B):
    """No width or basis is refused: the wrappers' checks take every F >=
    1 and B >= 1, and each kernel family names the instance that runs it
    (the tuned one where ``tuned_width`` holds, else the general one,
    whose Z feature tiles of NT threads cover F with NT <= 256)."""
    mix.check_width(F)
    cf.check_width(F, B)
    assert msg.tuned_width(F, B) == (F % 32 == 0 and F <= 256)
    assert msg.tuned_width(F, B, wgrad=True) == (
        msg.tuned_width(F, B) and B + 1 <= 32)
    assert mix.tuned_width(F, bwd=True) == (F % 32 == 0 and F <= 256)
    assert mix.tuned_width(F, bwd=False) == (F <= mix.FWD_MAX_F)
    assert cf.tuned_width(F, B) == (F in (64, 128) and B <= 32)
    Z, NT = msg.gen_tiles(F), msg.gen_threads(F)
    assert NT % 32 == 0 and NT <= msg.GEN_TILE and (Z - 1) * NT < F <= Z * NT
    assert cf.gen_tiles(F) == Z
    if not msg.tuned_width(F, B):
        assert msg.gen_name("msg_fwd") in msg.LAUNCHES
    assert msg.gen_name("msg_bwd_geores_bf16") == "msg_bwd_geores_gen_bf16"


@pytest.mark.parametrize("F", [30, 36, 279])
def test_padded_weights_give_the_unpadded_outputs(F):
    """K3's zero-padded weights (``pad_weights``, each block of F rows or
    columns padded to FP = F rounded up to 32) on inputs zero-padded the
    same way give the unpadded twin's outputs at the first F columns of
    each block: every padded term is an exact zero (Vn's padding columns,
    sqrt(eps), meet zero rows of k0), so in float64 the two differ only by
    the BLAS's blocking of the longer sums (2e-16 relative at F = 30; at
    F = 36 and 279 not at all); and ``padded_weights`` makes them once per
    parameter version."""
    c = mixing_case(A=37, F=F, seed=F)
    t = [torch.tensor(c[k]).double() for k in MIX_INPUTS]
    FP = mix.fwd_width(F)

    def pad(x, blocks):
        out = x.new_zeros((x.shape[0], blocks, FP))
        out[..., :F] = x.reshape(x.shape[0], blocks, F)
        return out.reshape(x.shape[0], -1)

    want = mix.painn_mixing_plain(*t, 1e-8, "ssp")
    w = mix.pad_weights(*t[4:])
    got = mix.painn_mixing_plain(pad(t[0], 1), pad(t[1], 3), pad(t[2], 1),
                                 pad(t[3], 3), *w, 1e-8, "ssp")
    np.testing.assert_allclose(got[0][:, :F].numpy(), want[0].numpy(),
                               rtol=1e-15, atol=1e-14)
    mu = got[1].reshape(-1, 3, FP)[..., :F].reshape(-1, 3 * F)
    np.testing.assert_allclose(mu.numpy(), want[1].numpy(), rtol=1e-15,
                               atol=1e-14)
    assert not got[0][:, F:].any()
    weights = [a.float() for a in t[4:]]
    first = mix.padded_weights(*weights)
    assert mix.padded_weights(*weights) is first
    with torch.no_grad():
        weights[0].add_(1.0)             # a new parameter version
    again = mix.padded_weights(*weights)
    assert again is not first
    torch.testing.assert_close(again[0][:F, :F], weights[0][:, :F])
