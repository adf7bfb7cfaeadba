"""PyTorch port, PaiNN's row-9 path: the radial bases and cutoffs (ops and
modules), K15's twin (the message VJP that returns the geometry cotangent
and the filter-weight cotangent), the filter-weight cotangents of K2's and
K7's twins, and the whole PaiNN-128x3 with a trainable Gaussian basis, a
Bessel basis or a mollifier cutoff against the JAX package's column path.
The CUDA kernels are held against their twins in
``test_torch_port_kernels.py``.

Inputs are made with numpy from fixed seeds and handed to both packages;
the JAX package runs its XLA path (``IMPL="xla"``) on the CPU.
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
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.nn import cutoff as jcutoff_nn
from schnetpack_tpu.nn import radial as jradial_nn
from schnetpack_tpu.ops import cellblock as jcellblock
from schnetpack_tpu.ops import colblock as jcb
from schnetpack_tpu.ops import colblock_geo as jgeo
from schnetpack_tpu.ops import cutoff as jcutoff
from schnetpack_tpu.ops import radial as jradial
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu_torch import nn as tnn
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic import Atomwise, Forces, PairwiseDistances
from schnetpack_tpu_torch.convert import (
    load_jax_params, params_from_jax, with_radial_params,
)
from schnetpack_tpu_torch.md import (
    CellBlockNeighborListMD, MaxwellBoltzmannInit, Simulator, VelocityVerlet,
    load_molecules,
)
from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.ops import colblock_message as msg
from schnetpack_tpu_torch.ops import colblock_select as sel
from schnetpack_tpu_torch.ops import cutoff as cutoff_ops
from schnetpack_tpu_torch.ops import radial as radial_ops
from schnetpack_tpu_torch.ops.colblock_geo import geo_fwd_plain
from schnetpack_tpu_torch.representation import PaiNN
from schnetpack_tpu_torch.units import _parse_unit, md_units
from torch_port_cases import (
    MSG_ATOL, MSG_RTOL, message_case, torch_message_args,
)
from test_torch_port_hybrid import _jax_message_through_geometry
from test_torch_port_model import ASSET, CUTOFF, E_RTOL, F_ATOL, ROOT, fcc_box
from test_torch_port_so3net import _box, _jax_column_inputs, port_inputs

FIXTURE = {k: os.path.join(ROOT, "tests", "data",
                           f"port_ref_painn_{k}_argon.npz")
           for k in ("trbf", "bessel")}
# the same f32 formulas elementwise in both packages
RADIAL_RTOL, RADIAL_ATOL = 1e-5, 1e-6
# their gradients w.r.t. d: sums over the basis of f32 terms that cancel
# near small d (sin(fd)/d^2 against f cos(fd)/d)
RADIAL_GRAD_RTOL, RADIAL_GRAD_ATOL = 1e-4, 1e-5
# gradients w.r.t. the basis parameters: f32 sums over ~30k edges and
# three message-passing blocks in another order
PARAM_GRAD_RTOL, PARAM_GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jcellblock, "IMPL", "xla")


def _distances(seed=0, n=400):
    """Distances over [0, 6.5] A with exact zeros and the cutoff itself."""
    rng = np.random.RandomState(seed)
    d = rng.uniform(0.0, 6.5, n).astype(np.float32)
    d[:4] = [0.0, 0.0, 5.0, 2.5]
    return d


def _radial_params(kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "bessel":
        return (radial_ops.bessel_rbf_params(8, 5.0),)
    fn = {"gaussian": radial_ops.gaussian_rbf_params,
          "centered": radial_ops.gaussian_rbf_centered_params}[kind]
    centers, widths = fn(8, 5.0, 0.5)
    return ((centers + rng.uniform(-0.1, 0.1, 8)).astype(np.float32),
            (widths * rng.uniform(0.9, 1.1, 8)).astype(np.float32))


# ------------------------------------------------------- bases and cutoffs
@pytest.mark.parametrize("kind", ["gaussian", "centered", "bessel"])
def test_radial_ops_and_grads_match_jax(kind):
    jfn = jradial.bessel_rbf if kind == "bessel" else jradial.gaussian_rbf
    tfn = radial_ops.bessel_rbf if kind == "bessel" else radial_ops.gaussian_rbf
    if kind == "bessel":
        np.testing.assert_array_equal(radial_ops.bessel_rbf_params(8, 5.0),
                                      jradial.bessel_rbf_params(8, 5.0))
    else:
        for ours, theirs in [
                (radial_ops.gaussian_rbf_params, jradial.gaussian_rbf_params),
                (radial_ops.gaussian_rbf_centered_params,
                 jradial.gaussian_rbf_centered_params)]:
            for a, b in zip(ours(8, 5.0, 0.5), theirs(8, 5.0, 0.5)):
                np.testing.assert_array_equal(a, b)
    args = (_distances(),) + _radial_params(kind)
    g = np.random.RandomState(1).randn(len(args[0]), 8).astype(np.float32)
    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    want_g = vjp(jnp.asarray(g))
    ins = [torch.tensor(a).requires_grad_(True) for a in args]
    out = tfn(*ins)
    got_g = torch.autograd.grad(out, ins, torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               RADIAL_RTOL, RADIAL_ATOL)
    for name, a, b in zip(("d", "p0", "p1"), got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   RADIAL_GRAD_RTOL, RADIAL_GRAD_ATOL,
                                   err_msg=f"grad {name}")
    assert np.isfinite(out.detach().numpy()).all()


@pytest.mark.parametrize("kind", ["cosine", "mollifier", "switch"])
def test_cutoff_ops_and_grads_match_jax(kind):
    jfn, tfn, args = {
        "cosine": (jcutoff.cosine_cutoff, cutoff_ops.cosine_cutoff, (5.0,)),
        "mollifier": (jcutoff.mollifier_cutoff, cutoff_ops.mollifier_cutoff,
                      (5.0,)),
        "switch": (jcutoff.switch_function, cutoff_ops.switch_function,
                   (2.5, 5.0)),
    }[kind]
    d = _distances(seed=2)
    want, vjp = jax.vjp(lambda x: jfn(x, *args), jnp.asarray(d))
    (want_g,) = vjp(jnp.ones_like(want))
    dt = torch.tensor(d).requires_grad_(True)
    out = tfn(dt, *args)
    (got_g,) = torch.autograd.grad(out.sum(), dt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               RADIAL_RTOL, RADIAL_ATOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               RADIAL_RTOL, RADIAL_ATOL)
    assert (out.detach().numpy()[d >= 5.0] == 0.0).all()


@pytest.mark.parametrize("kind", ["gaussian", "trainable", "centered",
                                  "bessel", "mollifier", "switch"])
def test_modules_match_jax(kind):
    jmod, tmod = {
        "gaussian": (jradial_nn.GaussianRBF(8, 5.0, 0.5),
                     tnn.GaussianRBF(8, 5.0, 0.5)),
        "trainable": (jradial_nn.GaussianRBF(8, 5.0, trainable=True),
                      tnn.GaussianRBF(8, 5.0, trainable=True)),
        "centered": (jradial_nn.GaussianRBFCentered(8, 5.0),
                     tnn.GaussianRBFCentered(8, 5.0)),
        "bessel": (jradial_nn.BesselRBF(8, 5.0), tnn.BesselRBF(8, 5.0)),
        "mollifier": (jcutoff_nn.MollifierCutoff(5.0),
                      tnn.MollifierCutoff(5.0)),
        "switch": (jcutoff_nn.SwitchFunction(2.5, 5.0),
                   tnn.SwitchFunction(2.5, 5.0)),
    }[kind]
    d = _distances(seed=3)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(d))
    want = np.asarray(jmod.apply(params, jnp.asarray(d)))
    np.testing.assert_allclose(tmod(torch.tensor(d)).detach().numpy(), want,
                               RADIAL_RTOL, RADIAL_ATOL)
    jparams = params.get("params", {})
    state = tmod.state_dict()
    assert set(state) == set(jparams)   # only a trainable basis saves any
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jparams[k]))
        assert dict(tmod.named_parameters())[k].requires_grad


# ------------------------------------------------------ message backwards
def _jax_message_fm_vjp(c, geo):
    """jax.vjp of the JAX package's ``painn_message_columns_fm`` (the XLA
    composition under ``IMPL="xla"``) in (x, mu, geo, FW_aug)."""
    jrefs = jcb.ColRefs.from_layout(c["lay"])
    ks = jrefs.ksizes

    def f(x, mu, g, fw):
        return jcb.painn_message_columns_fm(x, mu, jgeo.split_geo(g, ks), fw,
                                            jrefs)

    args = [jnp.asarray(a) for a in (c["x"], c["mu"], geo, c["FW"])]
    out, vjp = jax.vjp(f, *args)
    grads = vjp((jnp.asarray(c["g_dq"]), jnp.asarray(c["g_dmu"])))
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("seed", [0, 3])
def test_msg_bwd_src_twin_matches_jax_vjp(seed):
    """K15's twin on dx, dmu, ggeo (padded slots exactly 0) and gFW, and
    the row-9 op's autograd Function on the CPU."""
    c = message_case(seed=seed)
    t, refs, cw = torch_message_args(c)
    geo = geo_fwd_plain(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"],
                        with_d=False)
    assert geo.shape[2] == c["B"] + 4
    (jdq, jdmu), jgrads = _jax_message_fm_vjp(c, geo.numpy())

    got = msg.msg_bwd_src_plain(t["x"], t["mu"], geo, t["FW"], refs,
                                t["g_dq"], t["g_dmu"])
    for name, g, jg in zip(("dx", "dmu", "ggeo", "gFW"), got, jgrads):
        assert g.shape == jg.shape, name
        np.testing.assert_allclose(g.numpy(), jg, MSG_RTOL, MSG_ATOL,
                                   err_msg=name)
    pad = (refs.qcol < 0).numpy()
    assert pad.any(), "the case has no padded slots"
    np.testing.assert_array_equal(np.moveaxis(got[2].numpy(), 2, 3)[pad], 0)

    ins = [a.clone().requires_grad_(True)
           for a in (t["x"], t["mu"], geo, t["FW"])]
    dq, dmu = msg.painn_message_columns_fm(*ins, refs)
    np.testing.assert_allclose(dq.detach().numpy(), jdq, MSG_RTOL, MSG_ATOL)
    np.testing.assert_allclose(dmu.detach().numpy(), jdmu, MSG_RTOL, MSG_ATOL)
    grads = torch.autograd.grad((dq, dmu), ins, (t["g_dq"], t["g_dmu"]))
    for name, g, w in zip(("dx", "dmu", "ggeo", "gFW"), grads, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("form", ["full", "geores"])
def test_gfw_twins_of_fused_backwards_match_jax(form):
    """K2's and K7's twins return the filter-weight cotangent of the JAX
    composition geometry -> message (``jax.vjp``), with dx, dmu and dR."""
    c = message_case(seed=5)
    t, refs, cw = torch_message_args(c)
    _, jgrads = _jax_message_through_geometry(c)
    if form == "full":
        got = msg.msg_bwd_plain(t["x"], t["mu"], t["Rs"], t["FW"],
                                t["coff_fm"], cw, refs, c["cutoff"],
                                t["g_dq"], t["g_dmu"])
    else:
        geo = geo_fwd_plain(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"],
                            with_d=True)
        got = msg.msg_bwd_geores_plain(t["x"], t["mu"], geo, t["FW"], cw,
                                       refs, c["cutoff"], t["g_dq"],
                                       t["g_dmu"])
    assert len(got) == 4
    for name, g, jg in zip(("dx", "dmu", "dR", "gFW"), got, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, MSG_RTOL, MSG_ATOL,
                                   err_msg=name)


# ------------------------------------------------------------------ model
def _perturbed_radial(seed):
    """Initial centers and widths of GaussianRBF(20, 5), moved and scaled
    as ``scripts/make_port_reference_painn_radial.py`` does."""
    centers, widths = radial_ops.gaussian_rbf_params(20, CUTOFF)
    rng = np.random.RandomState(seed)
    return ((centers + rng.uniform(-0.05, 0.05, 20)).astype(np.float32),
            (widths * rng.uniform(0.95, 1.05, 20)).astype(np.float32))


#: (JAX radial basis, JAX cutoff function, port counterparts) per case
_CASES = {
    "trbf": lambda: (jradial_nn.GaussianRBF(20, CUTOFF, trainable=True),
                     None, tnn.GaussianRBF(20, CUTOFF, trainable=True),
                     None),
    "bessel": lambda: (jradial_nn.BesselRBF(20, CUTOFF),
                       jcutoff_nn.CosineCutoff(CUTOFF),
                       tnn.BesselRBF(20, CUTOFF), tnn.CosineCutoff(CUTOFF)),
    "mollifier": lambda: (None, jcutoff_nn.MollifierCutoff(CUTOFF), None,
                          tnn.MollifierCutoff(CUTOFF)),
}


def _port_painn(kind, params=None):
    _, _, radial, cutoff_fn = _CASES[kind]()
    pot = NeuralNetworkPotential(
        PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20, cutoff=CUTOFF,
              radial_basis=radial, cutoff_fn=cutoff_fn),
        [Atomwise(n_in=128), Forces()], input_modules=[PairwiseDistances()])
    if params is not None:
        pot.load_state_dict(params)
    return pot.requires_grad_(False)


def _jax_painn(kind, forces=True):
    radial, cutoff_fn, _, _ = _CASES[kind]()
    return JNNP(
        representation=JPaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                              cutoff=CUTOFF, radial_basis=radial,
                              cutoff_fn=cutoff_fn),
        input_modules=[JPairwiseDistances()],
        output_modules=[JAtomwise(output_key=P.energy)]
        + ([JForces()] if forces else []))


def _port_energy_param_grads(pot, inputs):
    """dE/d(centers, widths) of the port's potential (run by hand: the
    potential's forward differentiates w.r.t. the positions only)."""
    rb = pot.representation.radial_basis
    rb.requires_grad_(True)
    x = dict(inputs)
    for m in pot.input_modules:
        x = m(x)
    E = pot.output_modules[0](pot.representation(x))[TP.energy].sum()
    return torch.autograd.grad(E, [rb.centers, rb.widths])


@pytest.mark.parametrize("kind", ["trbf", "bessel", "mollifier"])
def test_painn_with_other_basis_or_cutoff_matches_jax(kind):
    """PaiNN-128x3 with the bench asset on the row-9 path against the JAX
    column path: energy, forces and, for the trainable basis, the energy's
    gradient w.r.t. its centers and widths."""
    R, cell = _box(4, seed=2, jitter=0.15)
    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    tree = load_jax_params(ASSET)
    if kind == "trbf":
        tree = with_radial_params(tree, *_perturbed_radial(seed=7))
    jin = _jax_column_inputs(lay, inputs)
    out = _jax_painn(kind).apply(tree, jin)
    E_ref = float(np.asarray(out[P.energy])[0])
    F_ref = np.asarray(out[P.forces])

    pot = _port_painn(kind, params_from_jax(tree))
    assert pot.representation.path == "column_fm"
    got = pot(inputs)
    np.testing.assert_allclose(float(got[TP.energy][0]), E_ref, rtol=E_RTOL)
    F = got[TP.forces].numpy()
    assert np.abs(F - F_ref).max() <= F_ATOL
    assert np.abs(F).max() > 0.05   # a force field worth comparing
    if kind != "trbf":
        return
    jpot = _jax_painn(kind, forces=False)

    def energy(radial):
        p = {"params": dict(tree["params"], representation=dict(
            tree["params"]["representation"], radial_basis=radial))}
        return jpot.apply(p, jin)[P.energy].sum()

    jg = jax.grad(energy)(tree["params"]["representation"]["radial_basis"])
    for name, g in zip(("centers", "widths"),
                       _port_energy_param_grads(pot, inputs)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]),
                                   PARAM_GRAD_RTOL, PARAM_GRAD_ATOL,
                                   err_msg=name)


def test_row9_path_runs_its_twins_as_often_as_the_kernels_launch(
        monkeypatch):
    """One energy + forces evaluation on the row-9 path runs K15's twin 3
    times and the positions' gather, its VJP, expand and fold once each,
    as the MD step on the card launches K15 and K11-K14."""
    counts = {"msg_bwd_src": 0, **dict.fromkeys(sel.LAUNCHES, 0)}

    def counting(module, name):
        plain = getattr(module, f"{name}_plain")

        def counted(*args):
            counts[name] += 1
            return plain(*args)
        monkeypatch.setattr(module, f"{name}_plain", counted)

    counting(msg, "msg_bwd_src")
    for name in sel.LAUNCHES:
        counting(sel, name)
    R, cell = _box(3, seed=1, jitter=0.3, stretch=1.1)
    _, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    pot = NeuralNetworkPotential(
        PaiNN(n_atom_basis=32, n_interactions=3, n_rbf=8, cutoff=CUTOFF,
              radial_basis=tnn.GaussianRBF(8, CUTOFF, trainable=True),
              generator=torch.Generator().manual_seed(0)),
        [Atomwise(n_in=32), Forces()], input_modules=[PairwiseDistances()])
    out = pot.requires_grad_(False)(inputs)
    assert torch.isfinite(out[TP.forces]).all()
    assert counts == {"msg_bwd_src": 3, "gather_fwd": 1, "gather_bwd": 1,
                      "expand_fwd": 1, "fold_fwd": 1}


def test_params_from_jax_covers_the_trainable_basis():
    tree = load_jax_params(ASSET, radial_from=FIXTURE["trbf"])
    params = params_from_jax(tree)
    state = _port_painn("trbf").state_dict()
    assert set(params) == set(state)
    for k, v in params.items():
        assert v.shape == state[k].shape, k
    ref = np.load(FIXTURE["trbf"])
    np.testing.assert_array_equal(
        params["representation.radial_basis.centers"].numpy(), ref["centers"])
    np.testing.assert_array_equal(
        params["representation.radial_basis.widths"].numpy(), ref["widths"])
    # a basis without parameters adds none
    assert set(params_from_jax(load_jax_params(ASSET))) \
        == set(_port_painn("bessel").state_dict())


def test_painn_dispatch_and_refusals():
    fixed = PaiNN(n_atom_basis=32, n_interactions=1, n_rbf=8,
                  radial_basis=tnn.GaussianRBF(8, CUTOFF, start=0.5))
    assert fixed.path == "full"
    np.testing.assert_allclose(fixed.cw[:, 0].numpy(),
                               np.linspace(0.5, CUTOFF, 8), rtol=1e-6)
    assert PaiNN(n_atom_basis=32, n_interactions=1, n_rbf=8,
                 fuse="hybrid").path == "hybrid"
    bessel = PaiNN(n_atom_basis=32, n_interactions=1, n_rbf=8,
                   radial_basis=tnn.BesselRBF(8, CUTOFF))
    assert bessel.path == "column_fm"
    R, cell = _box(3, seed=1, jitter=0.3, stretch=1.1)
    _, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    with pytest.raises(ValueError, match="PairwiseDistances"):
        bessel(inputs)
    with pytest.raises(NotImplementedError):
        PaiNN(shared_filters=True)
    with pytest.raises(NotImplementedError):
        PaiNN(shared_interactions=True)


def test_painn_trbf_md_20_steps():
    """20 NVE steps of the 256-atom box with the trainable-basis PaiNN of
    the fixture through ``SchNetPackCalculator``: finite positions and a
    bounded total-energy drift."""
    R, cell = _box(4, seed=3, jitter=0.05)
    conv = _parse_unit("Ang") * md_units().length
    mol = {TP.Z: np.full(len(R), 18, np.int64), TP.R: R, TP.cell: cell,
           TP.pbc: np.ones(3, bool)}
    system = MaxwellBoltzmannInit(30.0).initialize_system(
        load_molecules([mol], device="cpu"),
        torch.Generator().manual_seed(0))
    nbl = CellBlockNeighborListMD(CUTOFF * conv, skin=0.6 * conv)
    calc = SchNetPackCalculator(
        _port_painn("trbf"),
        params_from_jax(load_jax_params(ASSET, radial_from=FIXTURE["trbf"])),
        cutoff=CUTOFF, cutoff_shell=0.6, neighbor_list=nbl)
    sim = Simulator(system, VelocityVerlet(0.5), calc)
    sim.simulate(20, chunk_size=20)
    s = sim.system
    assert torch.isfinite(s.positions).all()
    E_pot = sim.logs[0]["energy"][:, 0, 0]
    T = sim.logs[0]["temperature"][:, 0, 0]
    E_tot = (E_pot + 1.5 * len(R) * md_units().kB * T) \
        / calc.energy_conversion
    assert np.abs(E_tot - E_tot[0]).max() / len(R) <= 1e-4
    assert 0.0 < float(s.temperature.mean()) < 300.0


@pytest.mark.parametrize("kind", ["trbf", "bessel"])
def test_radial_fixtures_are_the_bench_box(kind):
    """The full-size fixtures (``scripts/make_port_reference_painn_
    radial.py``) hold the jittered 10,976-atom bench box of the other
    fixtures, finite energy and forces whose net force vanishes, and (trbf)
    the perturbed centers and widths."""
    ref = np.load(FIXTURE[kind])
    base = np.load(os.path.join(ROOT, "tests", "data",
                                "port_ref_painn_argon.npz"))
    R0, cell = fcc_box(14)
    np.testing.assert_array_equal(ref["R"], base["R"])
    np.testing.assert_allclose(ref["cell"], cell)
    assert ref["forces"].shape == (10976, 3)
    assert np.isfinite(ref["energy"]) and np.isfinite(ref["forces"]).all()
    assert np.abs(ref["forces"].sum(0)).max() < 1e-2
    if kind == "trbf":
        c0, w0 = radial_ops.gaussian_rbf_params(20, CUTOFF)
        assert 0 < np.abs(ref["centers"] - c0).max() <= 0.05 + 1e-6
        ratio = ref["widths"] / w0
        assert ratio.min() >= 0.95 - 1e-6 and ratio.max() <= 1.05 + 1e-6


# ------------------------------------------------------- Pallas, interpret
@pytest.mark.slow
@pytest.mark.parametrize("resident", [True, False])
def test_pallas_row9_kernels_match_twin(monkeypatch, resident):
    """The two Pallas row-9 kernels (``colblock_pallas.py:945`` resident,
    ``:834`` otherwise) in interpret mode against K15's twin."""
    from schnetpack_tpu.ops import colblock_pallas as jpallas

    monkeypatch.setattr(jcellblock, "IMPL", "pallas_interpret")
    monkeypatch.setattr(jcellblock, "PIECES", 3)
    if not resident:
        monkeypatch.setattr(jpallas, "RESIDENT_BUDGET_BYTES", 0)
    c = message_case(seed=4)
    t, refs, cw = torch_message_args(c)
    geo = geo_fwd_plain(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"],
                        with_d=False)
    jrefs = jcb.ColRefs.from_layout(c["lay"])
    dx, dmu, ggeo, gFW = jpallas._msg_fm_bwd_call(
        jnp.asarray(c["x"]), jnp.asarray(c["mu"]),
        jgeo.split_geo(jnp.asarray(geo.numpy()), jrefs.ksizes),
        jnp.asarray(c["FW"]), jrefs.qcol, jrefs.dcol,
        (jnp.asarray(c["g_dq"]), jnp.asarray(c["g_dmu"])), jrefs.P,
        jrefs.ksizes, 3)
    want = msg.msg_bwd_src_plain(t["x"], t["mu"], geo, t["FW"], refs,
                                 t["g_dq"], t["g_dmu"])
    got = (dx, dmu, jgeo.concat_geo(ggeo), gFW)
    for name, g, w in zip(("dx", "dmu", "ggeo", "gFW"), got, want):
        np.testing.assert_allclose(np.asarray(g), w.numpy(), MSG_RTOL,
                                   MSG_ATOL, err_msg=name)
