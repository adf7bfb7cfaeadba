"""PyTorch port, the reduced-precision feature mode (``ops/precision.py``):
``round_pieces`` against the JAX package's ``_split_f32``, the PaiNN
message twins of K1/K2 (``fuse="full"``) and K6/K7 (``"hybrid"``) at
``pieces`` 2 and 1 against the JAX package's Pallas kernels at ``PIECES``
2 and 1 in interpret mode, the calculators' ``precision`` against the JAX
calculator's, the paths where the mode changes nothing, the paths the port
refuses and the JAX fault that makes it refuse them, and ``spkmd`` with
``calculator.precision=bf16``.

The JAX side comes from ``tests/data/port_ref_precision.npz``
(``scripts/make_port_reference_precision.py``), with one interpret-mode
case run live.  On the CPU, JAX's ``Precision.DEFAULT`` is f32, so its
bf16 mode keeps the filter products exact where the TPU takes bf16
operands.  The port keeps the forward filter rbf_aug @ FW_aug in f32 and
takes bf16 operands in its two cotangent products grbf = gW FW^T and gFW
= rbf^T gW (``ops/precision.py``).  So at one piece both sides get the
filter weights already rounded to bf16: the forward filter is then the
same f32 product on both sides, and only the port's rounding of gW and
rbf_aug in the backward products is left to bound.  Tolerances, with S
the same sum over the edges of each term's absolute value (the op on
|inputs|, all terms non-negative):

* a value rounded per edge in another f32 order can land one ulp apart:
  2^-15 of the edge's term at two pieces (a 16-bit significand), 2^-7 at
  one (bf16);
* at one piece the port also rounds gW and rbf_aug in the backward's two
  products (2^-9 of each term, each);

so the outputs dq, dmu are held to |d| <= 2^-15 S at two pieces and 2^-7
S at one, dx, dmu and gFW to 2^-15 S and (2^-7 + 2^-8) S, plus the
message ops' f32 atol.  The position cotangent dR runs through the
geometry chain, whose terms cancel: at two pieces its inputs are the f32
ones (the rounding is identical on both sides), so it is held to the
message tolerance; at one piece the chain's inputs move by up to 2^-8 of
each edge's term, and dR is held to 2^-7 of max |dR| (the JAX package's
own bf16-against-f32 envelope is 5e-2, ``tests/test_colblock.py:676-677``).

These bounds hold a twin that leaves out its per-edge rounding as well
(that moves an output by at most half an ulp a term).  So the mode's
effect is held too: against the port's f32 twin on the same rounded
inputs, the port's and JAX's outputs and feature cotangents move by the
same rms, within ``EFFECT`` (dR and gFW are left out: JAX's CPU keeps
their products in f32).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu.ops import cellblock as jcb
from schnetpack_tpu.ops.cellblock_pallas import _split_f32
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic import (
    Atomwise, Forces, PairwiseDistances,
)
from schnetpack_tpu_torch.convert import params_from_jax
from schnetpack_tpu_torch.datasets import write_extxyz
from schnetpack_tpu_torch.md import (
    CellBlockNeighborListMD, cli, load_molecules,
)
from schnetpack_tpu_torch.md.calculators import (
    EnsembleCalculator, SchNetPackCalculator,
)
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.nn import BesselRBF, GaussianRBF
from schnetpack_tpu_torch.ops import colblock_message as msg
from schnetpack_tpu_torch.ops.cellblock import build_column_layout
from schnetpack_tpu_torch.ops.colblock import (
    ColRefs, column_geometry, painn_message,
)
from schnetpack_tpu_torch.ops.colblock_geo import column_geometry_packed
from schnetpack_tpu_torch.ops.precision import (
    PIECES, ReducedPrecisionPathError, round_both, round_pieces,
)
from schnetpack_tpu_torch.ops.radial import gaussian_rbf_table
from schnetpack_tpu_torch.representation import (
    FieldSchNet, PaiNN, SchNet, SO3net,
)
from test_torch_port_ensemble import write_run_dir
from torch_port_cases import MSG_ATOL, MSG_RTOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "port_ref_precision.npz")
MSG_CUTOFF, MSG_B, MSG_F = 3.0, 12, 32
CALC_CUTOFF = 5.0
#: |d| <= TOL_S[pieces] * S + MSG_ATOL, the outputs (first two) and the
#: cotangents (see the module's docstring)
TOL_S = {2: (2.0 ** -15, 2.0 ** -15), 1: (2.0 ** -7, 2.0 ** -7 + 2.0 ** -8)}
#: the port's mode effect over JAX's: rms(port - f32) / rms(jax - f32)
EFFECT = (0.5, 2.0)
#: dR at one piece, as a share of max |dR|
DR_BF16 = 2.0 ** -7
#: the calculator's forces against the JAX calculator's, as a share of
#: max |F|: the message tolerances above carried through two
#: interactions and their mixing (f32 at two pieces)
CALC_TOL = {"mixed": 1e-4, "bf16": 2.0 ** -6}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref():
    with np.load(FIXTURE) as f:
        return dict(f)


@pytest.fixture
def jax_globals():
    """The JAX package's process globals, restored after the test."""
    old = (jcb.IMPL, jcb.PIECES, jcb.FUSE, jcb.WGRAD)
    yield
    jcb.IMPL, jcb.PIECES, jcb.FUSE, jcb.WGRAD = old


# ------------------------------------------------------------- (i) pieces
@pytest.mark.parametrize("pieces", [1, 2, 3])
def test_round_pieces_equals_split_f32_sum(pieces):
    """Bit for bit the f32 sum of ``_split_f32``'s terms, on random f32
    of both signs over magnitudes 1e-30 to 1e30 and at bf16 ties (normal
    numbers: XLA's CPU flushes subnormal results to zero)."""
    rng = np.random.RandomState(pieces)
    mag = 10.0 ** rng.uniform(-30, 30, 20_000)
    x = (mag * rng.choice([-1.0, 1.0], mag.shape)).astype(np.float32)
    # exactly halfway between two bf16 values, at 2^-20, 1 and 2^20
    ties = np.concatenate([
        (np.uint32(127 + e) << 23 | np.arange(128, dtype=np.uint32) << 16
         | 0x8000) for e in (-20, 0, 20)]).view(np.float32)
    x = np.concatenate([x, ties, -ties, [0.0, 1.0, -2.5]]).astype(np.float32)
    want = None
    for p in _split_f32(jnp.asarray(x), pieces):
        p = np.asarray(p.astype(jnp.float32))
        want = p if want is None else want + p
    got = round_pieces(torch.tensor(x), pieces).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if pieces == 3:
        np.testing.assert_array_equal(got, x)


def test_round_both_rounds_the_cotangent():
    x = torch.tensor([1.0 + 2 ** -10, 3.0], requires_grad=True)
    g = torch.tensor([1.0 + 2 ** -12, -1.0 - 2 ** -9])
    (gx,) = torch.autograd.grad(round_both(x, 1), x, g)
    torch.testing.assert_close(gx, round_pieces(g, 1), rtol=0, atol=0)
    assert float(gx[0]) == 1.0 and float(gx[1]) == -1.0


# ------------------------------------------------------- (ii) the twins
def message_case(pieces=3):
    """``scripts/make_port_reference_precision.py``'s message case at
    ``pieces``, with the port's ``build_column_layout`` (the filter
    weights rounded to bf16 at one piece, as the JAX side gets them)."""
    rng = np.random.RandomState(1)
    R = rng.uniform(0, 10.0, (90, 3))
    lay = build_column_layout(R, MSG_CUTOFF + 0.4, np.eye(3) * 10.0,
                              np.ones(3, bool))
    Ap, F = len(lay.order), MSG_F
    c = dict(lay=lay,
             Rs=(R[lay.order] * lay.slot_mask[:, None]).astype(np.float32),
             coff_fm=np.moveaxis(lay.offcol, -1, 2).astype(np.float32))
    c["x"] = (rng.randn(Ap, 3 * F) * 0.3).astype(np.float32)
    c["mu"] = (rng.randn(Ap, 3 * F) * 0.3).astype(np.float32)
    c["FW"] = (rng.randn(MSG_B + 1, 3 * F) * 0.3).astype(np.float32)
    c["g_dq"] = rng.randn(Ap, F).astype(np.float32)
    c["g_dmu"] = rng.randn(Ap, 3 * F).astype(np.float32)
    if pieces == 1:
        c["FW"] = round_pieces(torch.tensor(c["FW"]), 1).numpy()
    return c


def port_message(c, form, pieces):
    """(dq, dmu, gx, gmu, gR, gFW) of the port's op ``form`` at
    ``pieces`` (the CPU runs the twins), and S of each (the sums of the
    terms' absolute values; None for gR)."""
    refs = ColRefs.from_layout(c["lay"])
    cw = gaussian_rbf_table(MSG_B, MSG_CUTOFF)
    coff = torch.tensor(c["coff_fm"])
    ins = [torch.tensor(c[k]).requires_grad_(True)
           for k in ("x", "mu", "Rs", "FW")]
    if form == "full":
        out = msg.painn_message_columns_full_fused(
            *ins, coff, cw, refs, MSG_CUTOFF, pieces)
    else:
        with torch.no_grad():
            geo = column_geometry_packed(ins[2], coff, refs, cw, MSG_CUTOFF,
                                         with_d=True)
        out = msg.painn_message_columns_fm_geores(
            ins[0], ins[1], ins[2], geo, ins[3], coff, cw, refs, MSG_CUTOFF,
            pieces)
    cot = (torch.tensor(c["g_dq"]), torch.tensor(c["g_dmu"]))
    grads = torch.autograd.grad(out, ins, cot)
    # S: the op at three pieces on |inputs|, its VJP on |cotangents|
    with torch.no_grad():
        rbf, dirs = column_geometry(ins[2], coff, refs, cw, MSG_CUTOFF)
    leaves = [t.detach().abs().requires_grad_(True)
              for t in (ins[0], ins[1], ins[3])]
    s_out = painn_message(leaves[0], leaves[1], rbf.abs(), dirs.abs(),
                          leaves[2], refs)
    s_grads = torch.autograd.grad(s_out, leaves, [g.abs() for g in cot])
    return ([t.detach().numpy() for t in (*out, *grads)],
            [t.detach().numpy() for t in (*s_out, *s_grads[:2])]
            + [None, s_grads[2].numpy()])


NAMES = ("dq", "dmu", "gx", "gmu", "gR", "gFW")


def check_message(got, S, want, pieces):
    for i, (name, g, s, w) in enumerate(zip(NAMES, got, S, want)):
        if s is not None:
            bound = TOL_S[pieces][i >= 2] * s + MSG_ATOL
            worst = float((np.abs(g - w) / bound).max())
            assert worst <= 1.0, f"{name}: {worst:.3f} of the tolerance"
        elif pieces == 2:
            np.testing.assert_allclose(g, w, MSG_RTOL, MSG_ATOL,
                                       err_msg=name)
        else:
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= DR_BF16, f"{name}: {err:.3e} of max |dR|"


@pytest.mark.parametrize("form", ["full", "hybrid"])
@pytest.mark.parametrize("pieces", [2, 1])
def test_twins_match_jax_kernels(ref, form, pieces):
    """K1/K2's twins (full) and K6/K7's (hybrid) against the JAX package's
    kernels at the same ``PIECES``: outputs and the VJP in x, mu, R and
    FW; the mode is in effect (every output differs from f32's), and its
    effect on the outputs and feature cotangents is JAX's."""
    c = message_case(pieces)
    got, S = port_message(c, form, pieces)
    want = [ref[f"msg/{form}/{pieces}/{n}"] for n in NAMES]
    check_message(got, S, want, pieces)
    f32, _ = port_message(c, form, 3)
    for name, g, f in zip(NAMES, got, f32):
        assert not np.array_equal(g, f), f"{name}: equal to f32's"
    # the port's f32 twin on the inputs rounded as the mode rounds them
    rounded = dict(c, **{k: round_pieces(torch.tensor(c[k]), pieces).numpy()
                         for k in ("x", "mu", "g_dq", "g_dmu")})
    f32r, _ = port_message(rounded, form, 3)
    for name, g, w, f in list(zip(NAMES, got, want, f32r))[:4]:
        ratio = rms(g - f) / rms(w - f)
        assert EFFECT[0] <= ratio <= EFFECT[1], f"{name}: effect {ratio:.3f}"


def rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def test_twin_matches_live_jax_kernel(ref, jax_globals):
    """One fixture case run again in interpret mode (the fixture is the
    current JAX package's), and the port against it."""
    from schnetpack_tpu.ops.colblock import (
        ColRefs as JColRefs, painn_message_columns_full_fused as jfull,
    )
    from schnetpack_tpu.ops.radial import gaussian_rbf_params

    c = message_case(1)
    centers, widths = gaussian_rbf_params(MSG_B, MSG_CUTOFF, 0.0)
    cw = jnp.stack([jnp.asarray(centers, jnp.float32),
                    -0.5 / jnp.square(jnp.asarray(widths, jnp.float32))], 1)
    jrefs = JColRefs.from_layout(c["lay"])
    jcb.IMPL, jcb.PIECES, jcb.WGRAD = "pallas_interpret", 1, True
    out, vjp = jax.vjp(
        lambda x, mu, R, fw: jfull(x, mu, R, fw, jnp.asarray(c["coff_fm"]),
                                   cw, jrefs, MSG_CUTOFF),
        *[jnp.asarray(c[k]) for k in ("x", "mu", "Rs", "FW")])
    live = [np.asarray(o) for o in (*out, *vjp(
        (jnp.asarray(c["g_dq"]), jnp.asarray(c["g_dmu"]))))]
    for name, a in zip(NAMES, live):
        np.testing.assert_allclose(a, ref[f"msg/full/1/{name}"], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    got, S = port_message(c, "full", 1)
    check_message(got, S, live, 1)


def test_full_and_hybrid_twins_agree():
    """The two forms of one function in the bf16 mode: within the
    rounding-flip tolerance of each other (JAX's two are bit-equal)."""
    c = message_case(1)
    full, S = port_message(c, "full", 1)
    hybrid, _ = port_message(c, "hybrid", 1)
    check_message(hybrid, S, full, 1)


# ------------------------------------------------- (iii) the calculators
def calc_potential(fuse, tree=None):
    pot = NeuralNetworkPotential(
        PaiNN(n_atom_basis=32, n_interactions=2, n_rbf=20,
              cutoff=CALC_CUTOFF, fuse=fuse),
        [Atomwise(n_in=32), Forces()])
    if tree is not None:
        pot.load_state_dict(params_from_jax(tree))
    return pot


def fixture_tree(ref):
    tree = {}
    for k, v in ref.items():
        if k.startswith("calc/params/"):
            *path, leaf = k[len("calc/params/"):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def molecule(R, cell):
    return {TP.Z: np.full(len(R), 18, np.int64), TP.R: R, TP.cell: cell,
            TP.pbc: np.ones(3, bool)}


def calc_forces(calc, R, cell):
    system = load_molecules([molecule(R, cell)], device="cpu")
    s = calc.calculate(system, calc.init_state(system))
    return (s.forces[0] / calc.force_conversion).numpy()


@pytest.mark.parametrize("fuse", ["full", "hybrid"])
@pytest.mark.parametrize("precision", ["mixed", "bf16"])
def test_calculator_matches_jax_calculator(ref, fuse, precision):
    """PaiNN-32x2 on a 108-atom periodic box through the calculator on
    ``neighbor_list="cellblock"`` against the JAX calculator at the same
    ``precision`` and ``FUSE`` (interpret mode); the model's pieces set,
    and the forces not f32's."""
    R, cell = ref["calc/R"], ref["calc/cell"]
    calc = SchNetPackCalculator(calc_potential(fuse, fixture_tree(ref)),
                                cutoff=CALC_CUTOFF,
                                neighbor_list="cellblock",
                                precision=precision)
    assert calc.model.representation.pieces == PIECES[precision]
    got = calc_forces(calc, R, cell)
    want = ref[f"calc/forces/{fuse}/{precision}"]
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= CALC_TOL[precision], f"{err:.3e} of max |F|"
    calc.model.representation.pieces = 3
    assert not np.array_equal(calc_forces(calc, R, cell), got)


# ------------------------------------------- (iv) where nothing changes
def small_model(kind):
    if kind == "schnet":
        return NeuralNetworkPotential(
            SchNet(n_atom_basis=16, n_interactions=2, n_rbf=8,
                   cutoff=CALC_CUTOFF), [Atomwise(n_in=16), Forces()])
    return NeuralNetworkPotential(
        PaiNN(n_atom_basis=16, n_interactions=2, n_rbf=8,
              cutoff=CALC_CUTOFF),
        [Atomwise(n_in=16), Forces()],
        input_modules=[PairwiseDistances(columns=False)])


@pytest.mark.parametrize("kind,neighbor_list", [
    ("painn", "all_pairs"), ("painn", "dense"), ("schnet", "cellblock")])
@pytest.mark.parametrize("precision", ["mixed", "bf16"])
def test_mode_changes_nothing_where_jax_runs_no_selection(
        ref, kind, neighbor_list, precision):
    """The flat and dense layouts and SchNet's column path read no
    ``PIECES`` in the JAX package: the forces are bit-equal to f32's."""
    torch.manual_seed(0)
    model = small_model(kind)
    R, cell = ref["calc/R"], ref["calc/cell"]
    kw = dict(cutoff=CALC_CUTOFF, neighbor_list=neighbor_list)
    want = calc_forces(SchNetPackCalculator(model, **kw), R, cell)
    got = calc_forces(SchNetPackCalculator(model, precision=precision,
                                           **kw), R, cell)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- (v) refusals
def refused_model(kind, pieces=3):
    common = dict(n_atom_basis=16, n_interactions=1, n_rbf=8,
                  cutoff=CALC_CUTOFF)
    painn = dict(common, pieces=pieces)
    inputs = [PairwiseDistances()]
    if kind == "painn_trbf":
        rep = PaiNN(**painn,
                    radial_basis=GaussianRBF(8, CALC_CUTOFF, trainable=True))
    elif kind == "painn_bessel":
        rep = PaiNN(**painn, radial_basis=BesselRBF(8, CALC_CUTOFF))
    elif kind == "so3net":
        rep = SO3net(**common, lmax=1)
    elif kind == "field_schnet":
        rep = FieldSchNet(**common)
    elif kind == "schnet":
        rep, inputs = SchNet(**common), []
    else:
        rep = PaiNN(**painn, fuse=kind)
    return NeuralNetworkPotential(rep, [Atomwise(n_in=16), Forces()],
                                  input_modules=inputs)


REFUSED = [("painn_trbf", "cellblock"), ("painn_bessel", "cellblock"),
           ("so3net", "cellblock"), ("field_schnet", "cellblock"),
           ("full", "cellblock_atom"), ("hybrid", "cellblock_atom"),
           ("schnet", "cellblock_atom")]


@pytest.mark.parametrize("kind,neighbor_list", REFUSED)
@pytest.mark.parametrize("ensemble", [False, True])
def test_refused_paths_raise_before_the_first_step(kind, neighbor_list,
                                                   ensemble):
    """Where the JAX mode rounds the positions, both calculators raise at
    construction; the same options at f32 build."""
    models = [refused_model(kind), refused_model(kind)]

    def build(precision):
        kw = dict(cutoff=CALC_CUTOFF, neighbor_list=neighbor_list,
                  precision=precision)
        if ensemble:
            return EnsembleCalculator(models, **kw)
        return SchNetPackCalculator(models[0], **kw)

    for precision in ("bf16", "mixed"):
        with pytest.raises(ReducedPrecisionPathError,
                           match="rounds the positions"):
            build(precision)
    build("f32")


def test_ensemble_sets_every_member():
    models = [refused_model("full"), refused_model("full")]
    EnsembleCalculator(models, cutoff=CALC_CUTOFF,
                       neighbor_list=CellBlockNeighborListMD(CALC_CUTOFF),
                       precision="bf16")
    assert [m.representation.pieces for m in models] == [1, 1]


@pytest.mark.parametrize("kind", ["painn_bessel", "cell"])
def test_painn_refuses_its_exact_only_paths(ref, kind):
    """PaiNN itself, given ``pieces=1``, raises on the row-9 column path
    and on the 27-cell layout."""
    model = refused_model("painn_bessel" if kind == "painn_bessel"
                          else "full", pieces=1)
    calc = SchNetPackCalculator(
        model, cutoff=CALC_CUTOFF,
        neighbor_list="cellblock" if kind == "painn_bessel"
        else "cellblock_atom")
    with pytest.raises(ReducedPrecisionPathError, match="pieces=3"):
        calc_forces(calc, ref["calc/R"], ref["calc/cell"])


# -------------------------------------------------------------- (vi) spkmd
def test_spkmd_runs_in_bf16(ref, tmp_path):
    """``spkmd`` with ``calculator.precision=bf16`` on the column layout:
    a few CPU steps from a run directory, the model in the bf16 mode."""
    cfg = {"_target_": "schnetpack_tpu.model.NeuralNetworkPotential",
           "representation": {"_target_": "schnetpack_tpu.representation."
                                           "PaiNN",
                              "n_atom_basis": 32, "n_interactions": 2,
                              "n_rbf": 20, "cutoff": CALC_CUTOFF},
           "input_modules": [],
           "output_modules": [{"_target_": "schnetpack_tpu.atomistic."
                                           "Atomwise",
                               "output_key": "energy"},
                              {"_target_": "schnetpack_tpu.atomistic."
                                           "Forces"}]}
    run = write_run_dir(tmp_path / "run", cfg, fixture_tree(ref))
    xyz = str(tmp_path / "argon.xyz")
    write_extxyz(xyz, [{"numbers": np.full(108, 18), "positions":
                        ref["calc/R"], "cell": ref["calc/cell"]}])
    sim = cli.main([f"system.molecule_file={xyz}",
                    f"calculator.model_dir={run}",
                    "calculator.neighbor_list=cellblock",
                    "calculator.precision=bf16", "dynamics=nve",
                    "dynamics.n_steps=4", "dynamics.chunk_size=2",
                    f"simulation_dir={tmp_path / 'md'}", "device=cpu"])
    assert sim.calculator.model.representation.pieces == 1
    assert torch.isfinite(sim.system.positions).all()
    assert float(sim.system.temperature.max()) > 0.0


# ------------------------------------------- (vii) the reference's fault
def test_jax_bf16_mode_rounds_gathered_positions(jax_globals):
    """The evidence for the refusals: the JAX package's ``column_gather``
    of the positions in interpret mode at ``PIECES=1`` moves them by up to
    half a bf16 ulp of the coordinates (0.0625 A at 16-32 A), against
    ``PIECES=3``."""
    from schnetpack_tpu.ops.cellblock import build_column_layout as jbuild
    from schnetpack_tpu.ops.colblock import ColRefs as JColRefs
    from schnetpack_tpu.ops.colblock import column_gather

    rng = np.random.RandomState(0)
    R = rng.uniform(0, 20.0, (200, 3))
    lay = jbuild(R, 3.4, np.eye(3) * 20.0, np.ones(3, bool))
    refs = JColRefs.from_layout(lay)
    Rs = jnp.asarray((R[lay.order] * lay.slot_mask[:, None]).astype(
        np.float32))
    jcb.IMPL = "pallas_interpret"
    out = {}
    for p in (3, 1):
        jcb.PIECES = p
        out[p] = np.asarray(column_gather(Rs, refs))
    real = np.asarray(lay.qcol) >= 0
    exact, bf = out[3][real], out[1][real]
    d = np.abs(bf - exact)
    half_ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(exact), 1e-30)))
                       - 8)
    assert (d <= half_ulp).all()
    assert 0.03 < d.max() <= 0.0625
