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
from schnetpack_tpu_torch.ops.colblock import ColRefs
from torch_port_cases import (
    MIX_INPUTS, cfconv_case, message_case, mixing_case, torch_message_args,
)

sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

#: the widths and bases the acceptance names, each taken by some instance,
#: and F = 1024 and B = 2000, past what K10's general tiles and the
#: message backward's basis arrays hold in shared memory
WIDTHS = (1, 30, 50, 96, 288, 353, 512, 1024)
BASES = (20, 31, 50, 300, 2000)


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
    (the tuned one where ``tuned_width`` holds, else the general one: the
    message instances' Z feature tiles of NT threads cover F with NT <=
    256, the cfconv and mixing ones pad F to a multiple of 32; the general
    instances keep what does not fit shared memory in global scratch)."""
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
    Fp = cf.gen_width(F)
    assert Fp % 32 == 0 and F <= Fp < F + 32
    assert mix.fwd_width(F) == Fp
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


def _pad_cols(t, blocks, F, FP):
    """[rows, blocks F] -> [rows, blocks FP], each block zero-padded."""
    out = t.new_zeros((t.shape[0], blocks, FP))
    out[..., :F] = t.reshape(t.shape[0], blocks, F)
    return out.reshape(t.shape[0], -1)


@pytest.mark.parametrize("F,B", [(30, 20), (96, 300), (200, 50)])
def test_cfconv_padded_weights_give_the_unpadded_backward(F, B):
    """K10's general instance's padded weights (``pad_gen_weights``: W1 to
    [Bp, Fp], W2 to [Fp, Fp], b1 and b2 to Fp, Fp = F rounded up to 32,
    Bp = B + 1 rounded up to 8) on h, g and a geometry zero-padded the same
    way give the unpadded twin's VJP, in float64: dh and the geometry
    cotangent at the real columns and channels, the weight cotangents at
    the real rows and columns, and zeros at every padded one (a padded
    filter is ssp(0) = 0 against a zero row of W2, and gpre and gz1 are 0
    there); ``gen_padded_weights`` makes them once per parameter
    version."""
    c = cfconv_case(F=F, B=B, seed=F + B, n=110, L=11.0)
    refs = ColRefs.from_layout(c["lay"])
    h, geo, W1, b1, W2, b2, g = (torch.tensor(c[k]).double() for k in (
        "h", "geo", "W1", "b1", "W2", "b2", "g"))
    want = cf.cf_bwd_plain(h, geo, W1, b1, W2, b2, refs, g)
    W1p, b1p, W2p, b2p = cf.pad_gen_weights(W1, b1, W2, b2)
    Bp, Fp = W1p.shape
    assert Fp == cf.gen_width(F) and Fp % 32 == 0 and Bp == cf._bp(B)
    geo_p = geo.new_zeros((*geo.shape[:2], Bp + 4, geo.shape[3]))
    geo_p[:, :, :B] = geo[:, :, :B]
    geo_p[:, :, Bp:] = geo[:, :, B:]
    got = cf.cf_bwd_plain(_pad_cols(h, 1, F, Fp), geo_p, W1p, b1p, W2p, b2p,
                          refs, _pad_cols(g, 1, F, Fp))
    real = [(got[0][:, :F], want[0]),
            (got[1][:, :, :B], want[1][:, :, :B]),
            (got[1][:, :, Bp:], want[1][:, :, B:]),
            (got[2][:B, :F], want[2]), (got[3][:F], want[3]),
            (got[4][:F, :F], want[4]), (got[5][:F], want[5])]
    for a, w in real:
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-12)
    for pad in (got[0][:, F:], got[1][:, :, B:Bp], got[2][B:], got[2][:, F:],
                got[3][F:], got[4][F:], got[4][:, F:], got[5][F:]):
        np.testing.assert_allclose(pad.numpy(), 0.0, atol=1e-12)
    weights = [a.float() for a in (W1, b1, W2, b2)]
    first = cf.gen_padded_weights(*weights)
    assert cf.gen_padded_weights(*weights) is first
    with torch.no_grad():
        weights[2].add_(1.0)             # a new parameter version
    again = cf.gen_padded_weights(*weights)
    assert again is not first
    torch.testing.assert_close(again[2][:F, :F], weights[2])


@pytest.mark.parametrize("F,B", [(30, 20), (130, 31), (288, 50)])
def test_message_padded_weights_give_the_unpadded_backward(F, B):
    """The general message backward's padded FW_aug (``pad_gen_fw``: [B+1,
    Z, 3, NT], each part's features z NT .. z NT + NT of tile z, zero past
    F; here in the twin's part-major order) on x, mu and the cotangents
    zero-padded the same way give the unpadded twin's VJP (K2's form), in
    float64: dx, dmu and gFW at the real features, the position cotangent,
    and zeros at every padded feature; ``gen_padded_fw`` makes it once per
    parameter version."""
    c = message_case(F=F, B=B, seed=F + B)
    t, refs, cw = torch_message_args(c)
    x, mu, R, FW, coff, g_dq, g_dmu = (t[k].double() for k in (
        "x", "mu", "Rs", "FW", "coff_fm", "g_dq", "g_dmu"))
    cw = cw.double()
    want = msg.msg_bwd_plain(x, mu, R, FW, coff, cw, refs, c["cutoff"],
                             g_dq, g_dmu)
    Z, NT = msg.gen_tiles(F), msg.gen_threads(F)
    FP = Z * NT
    FWp = msg.pad_gen_fw(FW)
    assert FWp.shape == (B + 1, Z, 3, NT)
    FWpm = FWp.transpose(1, 2).reshape(B + 1, 3 * FP)   # part-major
    got = msg.msg_bwd_plain(_pad_cols(x, 3, F, FP), _pad_cols(mu, 3, F, FP),
                            R, FWpm, coff, cw, refs, c["cutoff"],
                            _pad_cols(g_dq, 1, F, FP),
                            _pad_cols(g_dmu, 3, F, FP))

    def real(a):
        return a.reshape(a.shape[0], 3, FP)[..., :F].reshape(a.shape[0], -1)

    for a, w in ((real(got[0]), want[0]), (real(got[1]), want[1]),
                 (got[2], want[2]), (real(got[3]), want[3])):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-12)
    for i in (0, 1, 3):
        pad = got[i].reshape(got[i].shape[0], 3, FP)[..., F:]
        np.testing.assert_allclose(pad.numpy(), 0.0, atol=1e-12)
    FW32 = FW.float()
    first = msg.gen_padded_fw(FW32)
    assert msg.gen_padded_fw(FW32) is first
    with torch.no_grad():
        FW32.add_(1.0)
    assert msg.gen_padded_fw(FW32) is not first
