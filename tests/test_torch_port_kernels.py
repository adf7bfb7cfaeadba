"""PyTorch port: the CUDA kernels K1-K21 against their plain PyTorch twins,
on a card only (skipped without CUDA), and the entry points' default
device.  No jax import: on a machine
without jax run ``python -m pytest --noconftest -m gpu
tests/test_torch_port_kernels.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.md import load_molecules
from schnetpack_tpu_torch.ops import _build
from schnetpack_tpu_torch.ops import cellblock_gather as cg
from schnetpack_tpu_torch.ops import colblock_edge as edge
from schnetpack_tpu_torch.ops import colblock_geo as geo_op
from schnetpack_tpu_torch.ops import colblock_select as sel
from schnetpack_tpu_torch.ops import colblock_message as msg
from schnetpack_tpu_torch.ops import painn_fused as pf
from schnetpack_tpu_torch.ops import painn_mixing as mix
from schnetpack_tpu_torch.ops import schnet_columns as schnet
from schnetpack_tpu_torch.ops.colblock import (
    ColRefs, destination_order, source_order,
)
from schnetpack_tpu_torch.ops.colblock_shard import (
    COLS_AXIS, COLS_AXIS_Y, _halo_table,
)
from schnetpack_tpu_torch.ops.precision import round_pieces
from schnetpack_tpu_torch.ops.radial import gaussian_rbf_table
from torch_port_cases import (
    MIX_ATOL, MIX_INPUTS, MIX_RTOL, MSG_ATOL, MSG_RTOL, cell_case,
    cfconv_case, column_inputs, fcc_argon, message_case, mixing_case,
    narrow_row_sum_walk, slab_case, torch_message_args, wide_column_case,
)

#: the source-index modes of K11, K20 and K21 (ColRefs.shard_axis)
MODES = {"wrap": None, "halo_x": COLS_AXIS,
         "halo_xy": (COLS_AXIS, COLS_AXIS_Y)}


# weight cotangents of the wgrad instances: sums over every row or edge of
# products of the kernel's f32 factors, whose rounding (~1e-6 relative
# after the 128-long dot products that make them) walks over 12,800 rows
# or ~10^4 edges; the f64 partial sums remove the order's error, not the
# factors'.  Held normwise: ||g - w|| <= W_NORM_RTOL ||w||.
W_NORM_RTOL = 1e-5


def assert_normwise(got, want, name=""):
    err = float((got.double() - want.double()).norm())
    assert err <= W_NORM_RTOL * float(want.double().norm()), (name, err)


def f64(fn, *args, **kw):
    """``fn`` on float64 copies of its float32 tensor arguments, rounded
    back: the reference of the wgrad instances, whose weight cotangents
    sum every row or edge."""
    out = fn(*[a.double() if torch.is_tensor(a) and a.dtype == torch.float32
               else a for a in args], **kw)
    return [o.float() for o in out]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_message_kernels_match_twin(cuda_device):
    c = message_case(seed=2)
    t, refs, cw = torch_message_args(c, cuda_device)
    args = (t["x"], t["mu"], t["Rs"], t["FW"], t["coff_fm"], cw, refs,
            c["cutoff"])
    for got, want in zip(msg.msg_fwd_kernel(*args), msg.msg_fwd_plain(*args)):
        torch.testing.assert_close(got, want, rtol=MSG_RTOL, atol=MSG_ATOL)
    for got, want in zip(msg.msg_bwd_kernel(*args, t["g_dq"], t["g_dmu"]),
                         msg.msg_bwd_plain(*args, t["g_dq"], t["g_dmu"])):
        torch.testing.assert_close(got, want, rtol=MSG_RTOL, atol=MSG_ATOL)


def held(got, want32, want64, name=""):
    """Each output at the tolerance of the float64 twin, or, where f32
    arithmetic itself misses it (the f32 twin's own max miss over MSG_ATOL
    on the same data), within twice that miss: two f32 summation orders,
    each with comparable roundoff."""
    for i, (g, w32, w64) in enumerate(zip(got, want32, want64)):
        miss = float((g.double() - w64.double()).abs().max())
        own = float((w32.double() - w64.double()).abs().max())
        if own <= MSG_ATOL:
            torch.testing.assert_close(g, w64, rtol=MSG_RTOL, atol=MSG_ATOL)
        else:
            assert miss <= 2 * own, (name, i, miss, own)


def _check_message_family(c, dev, wgrad, width_of=None):
    """K1/K2, K6/K7 and K6/K15 against their twins on ``message_case`` c;
    with ``wgrad`` also the wgrad instances of K2, K7 and K15, whose gFW
    is held to the twin in float64 (normwise), their other outputs
    elementwise.  ``width_of``: the Gaussians take the width of the
    table of that many functions over the same cutoff."""
    t, refs, cw = torch_message_args(c, dev)
    if width_of is not None:
        cw[:, 1] = gaussian_rbf_table(width_of, c["cutoff"], device=dev)[0, 1]
    cots = (t["g_dq"], t["g_dmu"])
    full = (t["x"], t["mu"], t["Rs"], t["FW"], t["coff_fm"], cw, refs,
            c["cutoff"])
    gargs = (t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    geo = geo_op.geo_fwd_kernel(*gargs)
    geo4 = geo_op.geo_fwd_kernel(*gargs, with_d=False)
    hyb = (t["x"], t["mu"], geo, t["FW"], cw, refs, c["cutoff"])
    src = (t["x"], t["mu"], geo4, t["FW"], refs)
    for kern, plain, args in [
            (msg.msg_fwd_kernel, msg.msg_fwd_plain, full),
            (msg.msg_fwd_geo_kernel, msg.msg_fwd_geo_plain,
             (t["x"], t["mu"], geo, t["FW"], refs))]:
        for g, w in zip(kern(*args), plain(*args)):
            torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    for kern, plain, args in [
            (msg.msg_bwd_kernel, msg.msg_bwd_plain, full),
            (msg.msg_bwd_geores_kernel, msg.msg_bwd_geores_plain, hyb),
            (msg.msg_bwd_src_kernel, msg.msg_bwd_src_plain, src)]:
        want = f64(plain, *args, *cots)
        got = kern(*args, *cots)
        assert len(got) == 3
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
        if wgrad:
            got = kern(*args, *cots, wgrad=True)
            assert len(got) == 4
            for g, w in zip(got[:3], want):
                torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
            assert_normwise(got[3], want[3], kern.__name__)


@pytest.mark.gpu
@pytest.mark.parametrize("F,B", [(64, 20), (128, 20), (256, 20), (128, 27)])
def test_message_kernels_at_widths_match_twin(cuda_device, F, B):
    """The message kernels at F = 64, 128 and 256 with PaiNN's 20 basis
    functions (the instance that keeps the filter weights in registers),
    and at B = 27 (24 < B+1 <= 32: the instance that reads them through
    L1, the widest basis the wgrad instances take), plain and wgrad.  The
    Gaussians keep the 20-function table's width at every B: the
    27-function table's narrower ones at the case's 3 A cutoff leave the
    fused position cotangent (|dR| up to 47) outside atol 1e-5 in f32
    arithmetic itself (the f32 twin misses the f64 twin there by 3.4e-5)."""
    _check_message_family(message_case(F=F, B=B, seed=F), cuda_device,
                          wgrad=True, width_of=20)


@pytest.mark.gpu
def test_message_kernels_at_b28_native_width(cuda_device):
    """B = 27 (B+1 = 28) with the 27-function table's own width: there
    f32 arithmetic itself misses the float64 twin by more than MSG_ATOL
    (the fused position cotangent, |dR| up to 47), so each output of K1,
    K6, K2, K7 and K15 (plain and wgrad) is held to within twice the f32
    twin's own max miss against the f64 twin on the same data: two f32
    summation orders, each with comparable roundoff.  The wgrad
    instances' filter-weight cotangent gFW is held normwise to the f64
    twin within W_NORM_RTOL, as at the other widths (the f32 twin's own
    normwise miss here is 4.1e-7)."""
    c = message_case(F=128, B=27, seed=128)
    t, refs, cw = torch_message_args(c, cuda_device)
    cots = (t["g_dq"], t["g_dmu"])
    full = (t["x"], t["mu"], t["Rs"], t["FW"], t["coff_fm"], cw, refs,
            c["cutoff"])
    gargs = (t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    geo = geo_op.geo_fwd_kernel(*gargs)
    geo4 = geo_op.geo_fwd_kernel(*gargs, with_d=False)
    hyb = (t["x"], t["mu"], geo, t["FW"], cw, refs, c["cutoff"])
    src = (t["x"], t["mu"], geo4, t["FW"], refs)

    def held(name, got, want32, want64):
        for i, (g, w32, w64) in enumerate(zip(got, want32, want64)):
            miss = float((g.double() - w64.double()).abs().max())
            own = float((w32.double() - w64.double()).abs().max())
            assert miss <= 2 * own, (name, i, miss, own)

    for kern, plain, args in [
            (msg.msg_fwd_kernel, msg.msg_fwd_plain, full),
            (msg.msg_fwd_geo_kernel, msg.msg_fwd_geo_plain,
             (t["x"], t["mu"], geo, t["FW"], refs))]:
        held(kern.__name__, kern(*args), plain(*args), f64(plain, *args))
    for kern, plain, args in [
            (msg.msg_bwd_kernel, msg.msg_bwd_plain, full),
            (msg.msg_bwd_geores_kernel, msg.msg_bwd_geores_plain, hyb),
            (msg.msg_bwd_src_kernel, msg.msg_bwd_src_plain, src)]:
        want64 = f64(plain, *args, *cots)
        want32 = plain(*args, *cots)
        held(kern.__name__, kern(*args, *cots), want32, want64)
        got = kern(*args, *cots, wgrad=True)
        assert len(got) == 4
        held(kern.__name__ + " wgrad", got[:3], want32, want64)
        assert_normwise(got[3], want64[3], kern.__name__ + " gFW")


@pytest.mark.gpu
def test_message_kernels_take_a_wide_basis(cuda_device):
    """B = 40 (B+1 > 32): the tuned forwards and plain backwards (the
    instance that reads the filter weights through L1) and the general
    wgrad instances (gFW in the blocks' own f64 partials in global memory)
    match their twins."""
    c = message_case(F=64, B=40, seed=7)
    before = dict(msg.LAUNCHES)
    _check_message_family(c, cuda_device, wgrad=True)
    moved = {k for k in before if msg.LAUNCHES[k] != before[k]}
    assert {"msg_bwd_gen", "msg_bwd_geores_gen", "msg_bwd_src_gen",
            "msg_fwd", "msg_bwd"} <= moved


#: phase 17 (a)'s sweep of the message family: F at B = 20, F = 30 at B+1
#: = 32, 51 and 1001 (the basis arrays in global scratch) and F = 512 at
#: B+1 = 301 (P3's n-tile split)
GEN_MSG_SHAPES = [(30, 20), (50, 20), (130, 20), (288, 20), (512, 20),
                  (30, 31), (30, 50), (512, 300), (30, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("F,B", GEN_MSG_SHAPES)
def test_general_message_kernels_match_twin(cuda_device, F, B):
    """The general instances of K1/K2, K6/K7 and K6/K15 (plain and wgrad)
    at widths the tuned bodies do not take, against their twins in float64
    (``held``: at F = 50 the f32 twin's own position cotangent misses the
    float64 one by 1.5e-5, |dR| up to 27), gFW normwise; the ops count
    them under ``_gen``."""
    c = message_case(F=F, B=B, seed=F + B)
    t, refs, cw = torch_message_args(c, cuda_device)
    cw[:, 1] = gaussian_rbf_table(20, c["cutoff"], device=cuda_device)[0, 1]
    cots = (t["g_dq"], t["g_dmu"])
    full = (t["x"], t["mu"], t["Rs"], t["FW"], t["coff_fm"], cw, refs,
            c["cutoff"])
    gargs = (t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    geo = geo_op.geo_fwd_kernel(*gargs)
    geo4 = geo_op.geo_fwd_kernel(*gargs, with_d=False)
    hyb = (t["x"], t["mu"], geo, t["FW"], cw, refs, c["cutoff"])
    src = (t["x"], t["mu"], geo4, t["FW"], refs)
    before = dict(msg.LAUNCHES)
    for kern, plain, args in [
            (msg.msg_fwd_kernel, msg.msg_fwd_plain, full),
            (msg.msg_fwd_geo_kernel, msg.msg_fwd_geo_plain,
             (t["x"], t["mu"], geo, t["FW"], refs))]:
        held(kern(*args), plain(*args), f64(plain, *args), kern.__name__)
    for kern, plain, args in [
            (msg.msg_bwd_kernel, msg.msg_bwd_plain, full),
            (msg.msg_bwd_geores_kernel, msg.msg_bwd_geores_plain, hyb),
            (msg.msg_bwd_src_kernel, msg.msg_bwd_src_plain, src)]:
        want32, want64 = plain(*args, *cots), f64(plain, *args, *cots)
        held(kern(*args, *cots), want32, want64, kern.__name__)
        got = kern(*args, *cots, wgrad=True)
        assert len(got) == 4
        held(got[:3], want32, want64, kern.__name__ + " wgrad")
        assert_normwise(got[3], want64[3], kern.__name__ + " gFW")
    moved = {k for k in before if msg.LAUNCHES[k] != before[k]}
    assert all(k.endswith("_gen") for k in moved if k.startswith("msg_bwd")
               or F % 32), moved
    assert "msg_bwd_gen" in moved


@pytest.mark.gpu
@pytest.mark.parametrize("A,act", [(37, "ssp"), (21, "silu")])
def test_mixing_kernels_match_twin(cuda_device, A, act):
    c = mixing_case(A=A)
    ins = [torch.tensor(c[k], device=cuda_device) for k in MIX_INPUTS]
    gq = torch.tensor(c["gq"], device=cuda_device)
    gmu = torch.tensor(c["gmu"], device=cuda_device)
    for got, want in zip(mix.mix_fwd_kernel(*ins, 1e-8, act),
                         mix.painn_mixing_plain(*ins, 1e-8, act)):
        torch.testing.assert_close(got, want, rtol=MIX_RTOL, atol=MIX_ATOL)
    for got, want in zip(mix.mix_bwd_kernel(*ins, 1e-8, act, gq, gmu),
                         mix.painn_mixing_bwd_plain(*ins, 1e-8, act, gq, gmu)):
        torch.testing.assert_close(got, want, rtol=MIX_RTOL, atol=MIX_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["ssp", "silu"])
@pytest.mark.parametrize("A", [37, 1000, 12800])
@pytest.mark.parametrize("F", [32, 64, 128, 256])
def test_mixing_backward_at_widths_matches_twin(cuda_device, F, A, act):
    """K4 (3xTF32 row tiles on the tensor cores) at every width it takes
    up to the widest, F = 256, on a ragged 37 rows, 1,000 rows and the
    column layout's 12,800, held to its twin in float64 at the mixing
    tolerances."""
    c = mixing_case(A=A, F=F, seed=F + A)
    ins = [torch.tensor(c[k], device=cuda_device) for k in MIX_INPUTS]
    cots = [torch.tensor(c[k], device=cuda_device) for k in ("gq", "gmu")]
    got = mix.mix_bwd_kernel(*ins, 1e-8, act, *cots)
    want = f64(mix.painn_mixing_bwd_plain, *ins, 1e-8, act, *cots)
    assert len(got) == 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=MIX_RTOL, atol=MIX_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["ssp", "silu"])
@pytest.mark.parametrize("A", [37, 1000, 12800])
@pytest.mark.parametrize("F", [32, 64, 128, 256])
def test_mixing_forward_at_widths_matches_twin(cuda_device, F, A, act):
    """K3 (3xTF32 row tiles on the tensor cores) at F = 32-256 on a ragged
    37 rows, 1,000 rows and the column layout's 12,800, held to its twin
    in float64 at the mixing tolerances."""
    c = mixing_case(A=A, F=F, seed=F + A + 1)
    ins = [torch.tensor(c[k], device=cuda_device) for k in MIX_INPUTS]
    got = mix.mix_fwd_kernel(*ins, 1e-8, act)
    want = f64(mix.painn_mixing_plain, *ins, 1e-8, act)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=MIX_RTOL, atol=MIX_ATOL)


@pytest.mark.gpu
def test_mixing_kernels_name_their_widths(cuda_device):
    """K4 runs its general instance at F = 48 and 288 and its tuned one at
    F = 32; K3 runs its tuned instance at F = 48 and 279 (weights padded
    to a multiple of 32) and F = 352, its widest under the opt-in shared
    memory limit, and its general instance at F = 353; each against the
    twin in float64, counted under its own name."""
    for F, fwd, bwd in ((32, "mix_fwd", "mix_bwd"),
                        (48, "mix_fwd", "mix_bwd_gen"),
                        (279, "mix_fwd", "mix_bwd_gen"),
                        (288, "mix_fwd", "mix_bwd_gen"),
                        (352, "mix_fwd", "mix_bwd_gen"),
                        (353, "mix_fwd_gen", "mix_bwd_gen")):
        c = mixing_case(A=37, F=F)
        ins = [torch.tensor(c[k], device=cuda_device) for k in MIX_INPUTS]
        cots = [torch.tensor(c[k], device=cuda_device) for k in ("gq", "gmu")]
        before = dict(mix.LAUNCHES)
        want = f64(mix.painn_mixing_plain, *ins, 1e-8, "ssp")
        for g, w in zip(mix.mix_fwd_kernel(*ins, 1e-8, "ssp"), want):
            torch.testing.assert_close(g, w, rtol=MIX_RTOL, atol=MIX_ATOL)
        want = f64(mix.painn_mixing_bwd_plain, *ins, 1e-8, "ssp", *cots)
        for g, w in zip(mix.mix_bwd_kernel(*ins, 1e-8, "ssp", *cots), want):
            torch.testing.assert_close(g, w, rtol=MIX_RTOL, atol=MIX_ATOL)
        assert {k for k in before if mix.LAUNCHES[k] != before[k]} == {
            fwd, bwd}, F


#: phase 17 (a)'s sweep of the mixing kernels, and the general K4's
#: tiles in global scratch from F = 257 on
GEN_MIX_WIDTHS = [30, 50, 130, 257, 288, 384, 512, 1024]


@pytest.mark.gpu
@pytest.mark.parametrize("A", [37, 12800])
@pytest.mark.parametrize("F", GEN_MIX_WIDTHS)
def test_general_mixing_kernels_match_twin(cuda_device, F, A):
    """K3 and K4 (plain and wgrad) at phase 17's widths, the tuned K3 with
    its cached padded weights up to F = 352 and the general instances
    elsewhere, against the twin in float64 (the weight cotangents
    normwise)."""
    c = mixing_case(A=A, F=F, seed=F + A)
    ins = [torch.tensor(c[k], device=cuda_device) for k in MIX_INPUTS]
    cots = [torch.tensor(c[k], device=cuda_device) for k in ("gq", "gmu")]
    for act in ("ssp", "silu"):
        want = f64(mix.painn_mixing_plain, *ins, 1e-8, act)
        for g, w in zip(mix.mix_fwd_kernel(*ins, 1e-8, act), want):
            torch.testing.assert_close(g, w, rtol=MIX_RTOL, atol=MIX_ATOL)
        want = f64(lambda *a: mix.painn_mixing_bwd_plain(*a, wgrad=True),
                   *ins, 1e-8, act, *cots)
        got = mix.mix_bwd_kernel(*ins, 1e-8, act, *cots, wgrad=True)
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=MIX_RTOL, atol=MIX_ATOL)
        for g, w in zip(got[2:], want[2:]):
            assert_normwise(g, w, f"mixing weights F={F}")
        for g, w in zip(mix.mix_bwd_kernel(*ins, 1e-8, act, *cots),
                        want[:2]):
            torch.testing.assert_close(g, w, rtol=MIX_RTOL, atol=MIX_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("F", [33, 64, 65, 255])
def test_mixing_backward_switches_held_to_twin(cuda_device, F):
    """K4 (plain and wgrad) on 12,800 rows at the switches of its
    instances: the general <1, 2> at FP = 64 (F = 33) beside the tuned one
    at F = 64, the general <2, 2> from FP = 96 (F = 65) to its widest tiles
    in shared memory (F = 255, FP = 256, 213 KB).  Over ~2.5M outputs f32
    arithmetic itself misses the strict elementwise tolerance here (the
    f32 twin by up to 1.44e-5 at F = 33), so the input cotangents are
    ``held`` to the float64 twin: at the tolerance where the f32 twin
    meets it, else within twice its miss; the weight cotangents
    normwise."""
    c = mixing_case(A=12800, F=F, seed=F + 1)
    ins = [torch.tensor(c[k], device=cuda_device) for k in MIX_INPUTS]
    cots = [torch.tensor(c[k], device=cuda_device) for k in ("gq", "gmu")]
    for act in ("ssp", "silu"):
        bwd = lambda *a: mix.painn_mixing_bwd_plain(   # noqa: E731
            *a, wgrad=True)
        want32 = bwd(*ins, 1e-8, act, *cots)
        want64 = f64(bwd, *ins, 1e-8, act, *cots)
        got = mix.mix_bwd_kernel(*ins, 1e-8, act, *cots, wgrad=True)
        held(got[:2], want32[:2], want64[:2], f"K4 wgrad F={F} {act}")
        for g, w in zip(got[2:], want64[2:]):
            assert_normwise(g, w, f"mixing weights F={F}")
        held(mix.mix_bwd_kernel(*ins, 1e-8, act, *cots), want32[:2],
             want64[:2], f"K4 F={F} {act}")


@pytest.mark.gpu
def test_mixing_smem_mirror_matches_the_kernel(cuda_device):
    """``mix_fwd_smem_bytes``, which names a K3 width past the opt-in
    limit before the launch, equals what the launcher asks for
    (``spk_mix_smem_bytes``) at padded and unpadded widths up to one past
    the limit; K4's row tiles at the padded width (``spk_mix_smem_bytes``
    of FP) fit the limit at every width the tuned instance takes and the
    general one up to FP = 256 (F = 255), and not past it (F = 257: the
    kScr instance)."""
    for F in (32, 36, 48, 128, 256, 279, 280, 352, 353):
        assert mix.mix_fwd_smem_bytes(F) == _build.query(
            "spk_mix_smem_bytes", F, 0)
    for F in (*range(32, 257, 32), 30, 33, 65, 255, 257, 288, 1024):
        got = _build.query("spk_mix_smem_bytes", mix.fwd_width(F), 1)
        assert (got <= _build.MAX_DYN_SMEM) == (mix.fwd_width(F) <= 256), F


@pytest.mark.gpu
def test_cfconv_smem_mirror_matches_the_kernel(cuda_device):
    """``cf_smem_bytes`` equals what the launchers ask for
    (``spk_cf_smem_bytes``: K9, K10 and K10's wgrad instance) at both
    widths and B = 8, 20 and 32, and fits the opt-in limit there; neither
    takes the column capacity P, since no kernel keeps a column's rows in
    shared memory (K9 runs at P = 222 and 1000 in
    ``test_cfconv_kernels_name_their_capacity``).  The general instances'
    launchers (``spk_cf_gen_smem``: the shared memory their plan asks for,
    0 where the tiles lie in global scratch) fit the opt-in limit at the
    swept shapes and on both sides of their switches, and K9's takes its
    weights into shared memory at (192, 20) and not at (193, 20), and its
    tiles into global scratch past (1696, 20) and (64, 1700)."""
    for F in schnet.N_FILTERS:
        for B in (8, 20, 32):
            for mode, bwd, wgrad in ((0, False, False), (1, True, False),
                                     (2, True, True)):
                got = _build.query("spk_cf_smem_bytes", F, B, mode)
                assert schnet.cf_smem_bytes(F, B, bwd, wgrad) == got, (
                    F, B, mode)
                assert got <= _build.MAX_DYN_SMEM
    def gen(F, B, mode):
        return _build.query("spk_cf_gen_smem", F, B, mode)

    for F, B in GEN_CF_SHAPES + [(1696, 20), (1697, 20), (30, 60000)]:
        for mode in range(3):
            assert gen(F, B, mode) <= _build.MAX_DYN_SMEM, (F, B, mode)
    # K9's: W2 ([Fp, Fp + 4] floats) in shared memory at Fp = 192, not at
    # Fp = 224; the group's tiles in global scratch past the switches
    assert gen(192, 20, 0) >= 4 * 192 * 196
    assert gen(193, 20, 0) < 4 * 224 * 228
    for (F, B), scr in (((1696, 20), False), ((1697, 20), True),
                        ((64, 1700), False), ((64, 1750), True)):
        assert (gen(F, B, 0) == 0) == scr, (F, B)


@pytest.mark.gpu
@pytest.mark.parametrize("A,F,act", [(37, 32, "ssp"), (1000, 64, "silu"),
                                     (1000, 128, "silu"), (12800, 128, "ssp"),
                                     (37, 256, "ssp"), (12800, 256, "silu"),
                                     (12800, 30, "ssp"), (37, 30, "silu"),
                                     (1000, 257, "ssp"), (3168, 512, "silu"),
                                     (1000, 1024, "ssp")])
def test_mixing_wgrad_instance_matches_twin(cuda_device, A, F, act):
    """K4's wgrad instance, tuned and general (F = 30, 257, 512 and 1024:
    row tiles in shared memory and in global scratch; the reduction's row
    ranges for F's own output tiles): the input cotangents equal the plain
    instance's (the same kernel, held to the twin in
    ``test_mixing_kernels_match_twin``), and gkmix, gk0, gb0, gk1, gb1 (f64
    sums of f32 row ranges) are held to the twin in float64; the op
    launches it when a weight requires grad, the plain instance
    otherwise."""
    c = mixing_case(A=A, F=F)
    ins = [torch.tensor(c[k], device=cuda_device) for k in MIX_INPUTS]
    cots = [torch.tensor(c[k], device=cuda_device) for k in ("gq", "gmu")]
    got = mix.mix_bwd_kernel(*ins, 1e-8, act, *cots, wgrad=True)
    want = f64(mix.painn_mixing_bwd_plain, *ins, 1e-8, act, *cots,
               wgrad=True)
    assert len(got) == len(want) == 7
    for g, w in zip(got[:2], mix.mix_bwd_kernel(*ins, 1e-8, act, *cots)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for name, g, w in zip(MIX_INPUTS[4:], got[2:], want[2:]):
        assert_normwise(g, w, name)
    before = dict(mix.LAUNCHES)
    w = [a.clone().requires_grad_(True) for a in ins[4:]]
    grads = torch.autograd.grad(
        mix.painn_mixing_fused(*ins[:4], *w, 1e-8, act), w, cots)
    for name, g, ref in zip(MIX_INPUTS[4:], grads, want[2:]):
        assert_normwise(g, ref, name)
    q = ins[0].clone().requires_grad_(True)
    torch.autograd.grad(mix.painn_mixing_fused(q, *ins[1:], 1e-8, act), q,
                        cots)
    fwd = "mix_fwd" if mix.tuned_width(F, bwd=False) else "mix_fwd_gen"
    gen = "" if mix.tuned_width(F, bwd=True) else "_gen"
    assert {k: mix.LAUNCHES[k] - before[k] for k in before
            if mix.LAUNCHES[k] != before[k]} == {
        fwd: 2, "mix_bwd" + gen: 1, "mix_bwd_wgrad" + gen: 1}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 3])
def test_hybrid_kernels_match_twin(cuda_device, seed):
    c = message_case(seed=seed)
    t, refs, cw = torch_message_args(c, cuda_device)
    gargs = (t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    geo = geo_op.geo_fwd_kernel(*gargs)
    torch.testing.assert_close(geo, geo_op.geo_fwd_plain(*gargs),
                               rtol=MSG_RTOL, atol=MSG_ATOL)
    fargs = (t["x"], t["mu"], geo, t["FW"], refs)
    for got, want in zip(msg.msg_fwd_geo_kernel(*fargs),
                         msg.msg_fwd_geo_plain(*fargs)):
        torch.testing.assert_close(got, want, rtol=MSG_RTOL, atol=MSG_ATOL)
    bargs = (t["x"], t["mu"], geo, t["FW"], cw, refs, c["cutoff"],
             t["g_dq"], t["g_dmu"])
    for got, want in zip(msg.msg_bwd_geores_kernel(*bargs),
                         msg.msg_bwd_geores_plain(*bargs)):
        torch.testing.assert_close(got, want, rtol=MSG_RTOL, atol=MSG_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 3])
def test_row9_kernel_matches_twin(cuda_device, seed):
    """K15 with and without the filter-weight cotangent, and the row-9 op
    with FW_aug requiring grad: it launches K6 and K15's wgrad instance,
    never the twins."""
    c = message_case(seed=seed)
    t, refs, cw = torch_message_args(c, cuda_device)
    geo = geo_op.geo_fwd_kernel(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"],
                                with_d=False)
    args = (t["x"], t["mu"], geo, t["FW"], refs, t["g_dq"], t["g_dmu"])
    want = msg.msg_bwd_src_plain(*args)
    got = msg.msg_bwd_src_kernel(*args)
    assert len(got) == 3
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    for g, w in zip(msg.msg_bwd_src_kernel(*args, wgrad=True), want):
        torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    before = dict(msg.LAUNCHES)
    ins = [a.clone().requires_grad_(True)
           for a in (t["x"], t["mu"], geo, t["FW"])]
    dq, dmu = msg.painn_message_columns_fm(*ins, refs)
    grads = torch.autograd.grad((dq, dmu), ins, (t["g_dq"], t["g_dmu"]))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    assert {k: msg.LAUNCHES[k] - before[k] for k in before} == {
        **dict.fromkeys(msg.LAUNCHES, 0), "msg_fwd_geo": 1,
        "msg_bwd_src": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 3])
def test_wgrad_instances_of_fused_backwards_match_twin(cuda_device, seed):
    """K2's and K7's wgrad instances (dx, dmu, dR, gFW), and the message ops
    with FW_aug requiring grad, which launch them."""
    c = message_case(seed=seed)
    t, refs, cw = torch_message_args(c, cuda_device)
    full = (t["x"], t["mu"], t["Rs"], t["FW"], t["coff_fm"], cw, refs,
            c["cutoff"])
    geo = geo_op.geo_fwd_kernel(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    hyb = (t["x"], t["mu"], geo, t["FW"], cw, refs, c["cutoff"])
    cots = (t["g_dq"], t["g_dmu"])
    for kern, plain, args in [
            (msg.msg_bwd_kernel, msg.msg_bwd_plain, full),
            (msg.msg_bwd_geores_kernel, msg.msg_bwd_geores_plain, hyb)]:
        got = kern(*args, *cots, wgrad=True)
        want = plain(*args, *cots)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    before = dict(msg.LAUNCHES)
    FW = t["FW"].clone().requires_grad_(True)
    for dq, dmu in [
            msg.painn_message_columns_full_fused(
                t["x"], t["mu"], t["Rs"], FW, t["coff_fm"], cw, refs,
                c["cutoff"]),
            msg.painn_message_columns_fm_geores(
                t["x"], t["mu"], t["Rs"], geo, FW, t["coff_fm"], cw, refs,
                c["cutoff"])]:
        (gFW,) = torch.autograd.grad((dq, dmu), FW, cots)
        torch.testing.assert_close(gFW, want[3], rtol=MSG_RTOL,
                                   atol=MSG_ATOL)
    assert {k: msg.LAUNCHES[k] - before[k] for k in before} == {
        **dict.fromkeys(msg.LAUNCHES, 0), "msg_fwd": 1, "msg_bwd": 1,
        "msg_fwd_geo": 1, "msg_bwd_geores": 1}


#: the reduced-precision instances against their twins at the same pieces:
#: per edge a rounding flip of one ulp of the mode (2^-15 of the term at
#: two pieces, 2^-7 at one), S the sum of the terms' absolute values (the
#: twin on |inputs|), beside the f32 tolerance; dR at one piece within
#: 2^-7 of max |dR| (its chain sums terms that cancel)
REDUCED_ULP = {2: 2.0 ** -15, 1: 2.0 ** -7}
#: those bounds hold an instance that skips its per-edge rounding as well
#: (at most half an ulp a term), so the mode's effect is held too: the
#: instance's rms distance from the f32 instance over its twin's from the
#: f32 twin, both f32 on the inputs rounded as the mode rounds them, on
#: the outputs a rounding of the mode reaches (at two pieces the features'
#: only: dq, dmu; dx, dmu)
MODE_EFFECT = (0.5, 2.0)


def _rms(t):
    return float(t.double().square().mean().sqrt())


def _effect(got, want, got3, want3, name, pieces):
    reached = 2 if pieces == 2 else 4
    for i, (g, w, g3, w3) in list(enumerate(zip(got, want, got3,
                                                 want3)))[:reached]:
        ratio = _rms(g - g3) / _rms(w - w3)
        assert MODE_EFFECT[0] <= ratio <= MODE_EFFECT[1], (name, i, ratio)


def _within(got, want, S, pieces, name):
    for i, (g, w) in enumerate(zip(got, want)):
        if S[i] is None:
            if pieces == 1:
                err = float((g - w).abs().max() / w.abs().max())
                assert err <= 2.0 ** -7, (name, i, err)
            else:
                torch.testing.assert_close(g, w, rtol=MSG_RTOL,
                                           atol=MSG_ATOL)
            continue
        lim = (REDUCED_ULP[pieces] + MSG_RTOL) * S[i] + MSG_ATOL
        worst = float(((g - w).abs() / lim).max())
        assert worst <= 1.0, (name, i, worst)


@pytest.mark.gpu
@pytest.mark.parametrize("pieces", [2, 1])
@pytest.mark.parametrize("F,B", [(128, 20), (64, 27), (64, 40), (30, 20),
                                 (288, 20)])
def test_reduced_precision_message_kernels_match_twin(cuda_device, pieces,
                                                      F, B):
    """K1/K2 and K6/K7 in their mixed and bf16 instances, with the filter
    weights in registers (B = 20) and read through L1 (B = 27, 40), plain
    and (B+1 <= 32) wgrad, and in their general instances at F = 30 and
    288, against their twins at the same pieces; the ops launch the mode's
    instances, counted under its names; each instance's mode effect is its
    twin's."""
    c = message_case(F=F, B=B, seed=F + B)
    t, refs, cw = torch_message_args(c, cuda_device)
    cw[:, 1] = gaussian_rbf_table(20, c["cutoff"], device=cuda_device)[0, 1]
    cots = (t["g_dq"], t["g_dmu"])
    geo = geo_op.geo_fwd_kernel(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    x, mu, FW = t["x"], t["mu"], t["FW"]
    with torch.no_grad():
        ab = [a.abs() for a in (x, mu, geo, FW)]
        S_f = msg.msg_fwd_geo_plain(*ab, refs)
        S_b = msg.msg_bwd_geores_plain(*ab, cw, refs, c["cutoff"],
                                       *(g.abs() for g in cots))
    S_b = [S_b[0], S_b[1], None, S_b[3]]
    xr, mur = (round_pieces(a, pieces) for a in (x, mu))
    cots3 = [round_pieces(g, pieces) for g in cots]
    full = (x, mu, t["Rs"], FW, t["coff_fm"], cw, refs, c["cutoff"])
    hyb = (x, mu, geo, FW, cw, refs, c["cutoff"])
    full3 = (xr, mur) + full[2:]
    hyb3 = (xr, mur) + hyb[2:]
    for kern, plain, args, args3 in [
            (msg.msg_fwd_kernel, msg.msg_fwd_plain, full, full3),
            (msg.msg_fwd_geo_kernel, msg.msg_fwd_geo_plain,
             (x, mu, geo, FW, refs), (xr, mur, geo, FW, refs))]:
        got, want = kern(*args, pieces=pieces), plain(*args, pieces=pieces)
        _within(got, want, S_f, pieces, kern.__name__)
        _effect(got, want, kern(*args3), plain(*args3), kern.__name__,
                pieces)
    for kern, plain, args, args3 in [
            (msg.msg_bwd_kernel, msg.msg_bwd_plain, full, full3),
            (msg.msg_bwd_geores_kernel, msg.msg_bwd_geores_plain, hyb,
             hyb3)]:
        want = plain(*args, *cots, pieces=pieces)
        want3 = plain(*args3, *cots3)
        got = kern(*args, *cots, pieces=pieces)
        assert len(got) == 3
        _within(got, want, S_b, pieces, kern.__name__)
        _effect(got, want, kern(*args3, *cots3), want3, kern.__name__,
                pieces)
        if B + 1 <= 32:
            got = kern(*args, *cots, wgrad=True, pieces=pieces)
            _within(got, want, S_b, pieces, kern.__name__ + " (wgrad)")
            _effect(got, want, kern(*args3, *cots3, wgrad=True), want3,
                    kern.__name__ + " (wgrad)", pieces)
    mode = {2: "_mixed", 1: "_bf16"}[pieces]
    before = dict(msg.LAUNCHES)
    ins = [a.clone().requires_grad_(True) for a in (x, mu, t["Rs"])]
    for dq, dmu in [
            msg.painn_message_columns_full_fused(
                *ins, FW, t["coff_fm"], cw, refs, c["cutoff"], pieces),
            msg.painn_message_columns_fm_geores(
                *ins, geo, FW, t["coff_fm"], cw, refs, c["cutoff"], pieces)]:
        torch.autograd.grad((dq, dmu), ins, cots)
    name = (lambda k: k + mode) if msg.tuned_width(F, B) else (
        lambda k: msg.gen_name(k + mode))
    assert {k: msg.LAUNCHES[k] - before[k] for k in before} == {
        **dict.fromkeys(msg.LAUNCHES, 0), name("msg_fwd"): 1,
        name("msg_bwd"): 1, name("msg_fwd_geo"): 1,
        name("msg_bwd_geores"): 1}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 3])
def test_raw_geometry_kernels_match_twin(cuda_device, seed):
    """K5 in its raw-phi form and K8, SchNet's geometry and its VJP."""
    c = message_case(seed=seed)
    t, refs, cw = torch_message_args(c, cuda_device)
    gargs = (t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    torch.testing.assert_close(
        geo_op.geo_fwd_kernel(*gargs, with_d=False, raw_phi=True),
        geo_op.geo_fwd_plain(*gargs, with_d=False, raw_phi=True),
        rtol=MSG_RTOL, atol=MSG_ATOL)
    nx, ny, Ktot = refs.qcol.shape
    g = torch.randn((nx, ny, c["B"] + 4, Ktot),
                    generator=torch.Generator().manual_seed(seed))
    g = g.to(cuda_device)
    torch.testing.assert_close(geo_op.geo_bwd_kernel(g, *gargs),
                               geo_op.geo_bwd_plain(g, *gargs),
                               rtol=MSG_RTOL, atol=MSG_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("F", [64, 128])
@pytest.mark.parametrize("seed", [3, 21])
def test_cfconv_kernels_match_twin(cuda_device, seed, F):
    """K9 and K10 at the kernels' widths (``N_FILTERS``) on synthetic
    raw-phi geometry; K10 held to the twin in float64: its gfcut channel,
    an F-long sum that can cancel, is within the tolerance of the float64
    result where the f32 twin's own sum is not always (1.22x it on the
    CPU walk's F = 128 case, ``test_torch_port_cf_sched.py``)."""
    c = cfconv_case(F=F, B=20, seed=seed)
    refs = ColRefs.from_layout(c["lay"], device=cuda_device)
    args = [torch.tensor(c[k], device=cuda_device)
            for k in ("h", "geo", "W1", "b1", "W2", "b2")]
    g = torch.tensor(c["g"], device=cuda_device)
    torch.testing.assert_close(schnet.cf_fwd_kernel(*args, refs),
                               schnet.cf_fwd_plain(*args, refs),
                               rtol=MSG_RTOL, atol=MSG_ATOL)
    want = f64(schnet.cf_bwd_plain, *args, refs, g)
    for got, w in zip(schnet.cf_bwd_kernel(*args, refs, g), want[:2]):
        torch.testing.assert_close(got, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    # the wgrad instance: also gW1, gb1, gW2, gb2, held to the twin in f64;
    # the op launches it when a filter weight requires grad
    got = schnet.cf_bwd_kernel(*args, refs, g, wgrad=True)
    assert len(got) == 6
    for gk, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(gk, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    for gk, w in zip(got[2:], want[2:]):
        assert_normwise(gk, w)
    before = dict(schnet.LAUNCHES)
    w = [a.clone().requires_grad_(True) for a in args[2:]]
    grads = torch.autograd.grad(
        schnet.schnet_cfconv_columns(*args[:2], *w, refs), w, g)
    for gk, ref in zip(grads, want[2:]):
        assert_normwise(gk, ref)
    assert {k: schnet.LAUNCHES[k] - before[k] for k in before
            if schnet.LAUNCHES[k] != before[k]} == {
        "cf_fwd": 1, "cf_bwd_wgrad": 1}


def _cfconv_bwd_checks(args, refs, g):
    """K10 and its wgrad instance against the twin in float64: dh and ggeo
    at the message tolerance, the weight cotangents normwise."""
    want = f64(schnet.cf_bwd_plain, *args, refs, g)
    for got, w in zip(schnet.cf_bwd_kernel(*args, refs, g), want[:2]):
        torch.testing.assert_close(got, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    got = schnet.cf_bwd_kernel(*args, refs, g, wgrad=True)
    assert len(got) == 6
    for gk, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(gk, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    for name, gk, w in zip(("gW1", "gb1", "gW2", "gb2"), got[2:], want[2:]):
        assert_normwise(gk, w, name)


@pytest.mark.gpu
@pytest.mark.parametrize("F", [64, 128])
@pytest.mark.parametrize("B", [8, 20, 32])
def test_cfconv_bwd_at_basis_widths(cuda_device, B, F):
    """K10 and its wgrad instance at B = 8, 20 and 32 (the padded basis
    width Bp = 16, 24 and 40) and at both widths on a 3 x 3 grid against
    the twin in float64."""
    c = cfconv_case(F=F, B=B, seed=B + 1, n=110, L=11.0)
    refs = ColRefs.from_layout(c["lay"], device=cuda_device)
    args = [torch.tensor(c[k], device=cuda_device)
            for k in ("h", "geo", "W1", "b1", "W2", "b2")]
    _cfconv_bwd_checks(args, refs, torch.tensor(c["g"], device=cuda_device))


#: phase 17 (a)'s sweep of the cfconv kernels at the general plans'
#: switches (``cfg_plan``): K9's weights from L2 from (193, 20) on, (192,
#: 20) under it; its tiles in global scratch at (64, 1750) and (64,
#: 2000), (64, 1700) under it; K10's wgrad tiles at (1024, 20) and K10's
#: at (64, 2000)
GEN_CF_SHAPES = [(30, 20), (96, 20), (192, 20), (193, 20), (256, 20),
                 (512, 20), (64, 50), (128, 50), (64, 300), (128, 300),
                 (1024, 20), (64, 1700), (64, 1750), (64, 2000)]


@pytest.mark.gpu
@pytest.mark.parametrize("F,B", GEN_CF_SHAPES)
def test_general_cfconv_kernels_match_twin(cuda_device, F, B):
    """K9 and K10 (plain and wgrad) in their general instances at phase
    17's shapes on a 3 x 3 grid, against the twin in float64 (``held``: the
    f32 twin's own K9 output misses it by up to 7.7e-5, |out| up to 182),
    the weight cotangents normwise, counted as ``cf_fwd_gen``,
    ``cf_bwd_gen`` and ``cf_bwd_wgrad_gen``."""
    c = cfconv_case(F=F, B=B, seed=F + B, n=110, L=11.0)
    refs = ColRefs.from_layout(c["lay"], device=cuda_device)
    args = [torch.tensor(c[k], device=cuda_device)
            for k in ("h", "geo", "W1", "b1", "W2", "b2")]
    before = dict(schnet.LAUNCHES)
    fwd = lambda *a: (schnet.cf_fwd_plain(*a),)   # noqa: E731
    held((schnet.cf_fwd_kernel(*args, refs),), fwd(*args, refs),
         f64(fwd, *args, refs), "K9")
    g = torch.tensor(c["g"], device=cuda_device)
    want32 = schnet.cf_bwd_plain(*args, refs, g)
    want64 = f64(schnet.cf_bwd_plain, *args, refs, g)
    held(schnet.cf_bwd_kernel(*args, refs, g), want32[:2], want64[:2], "K10")
    got = schnet.cf_bwd_kernel(*args, refs, g, wgrad=True)
    assert len(got) == 6
    held(got[:2], want32[:2], want64[:2], "K10 wgrad")
    for name, gk, w in zip(("gW1", "gb1", "gW2", "gb2"), got[2:], want64[2:]):
        assert_normwise(gk, w, name)
    assert {k: schnet.LAUNCHES[k] - before[k] for k in before
            if schnet.LAUNCHES[k] != before[k]} == {
        "cf_fwd_gen": 1, "cf_bwd_gen": 1, "cf_bwd_wgrad_gen": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("F,B", [(30, 20), (512, 20), (1024, 20),
                                 (64, 2000)])
def test_general_backwards_repeat_bit_for_bit(cuda_device, F, B):
    """The general cfconv forward and backward (plain and wgrad), message
    backward (plain and wgrad) and mixing backward (plain and wgrad) give
    the same bits on a second call: every output element has one writer
    and every sum one order (no atomics), also where K10's wgrad tiles
    (F = 1024), K9's and K10's (B = 2000) and K4's (F = 512, 1024) lie in
    global scratch."""
    c = cfconv_case(F=F, B=B, seed=F, n=110, L=11.0)
    refs = ColRefs.from_layout(c["lay"], device=cuda_device)
    args = [torch.tensor(c[k], device=cuda_device)
            for k in ("h", "geo", "W1", "b1", "W2", "b2")]
    g = torch.tensor(c["g"], device=cuda_device)
    assert torch.equal(schnet.cf_fwd_kernel(*args, refs),
                       schnet.cf_fwd_kernel(*args, refs))
    x = mixing_case(A=1000, F=F, seed=F)
    ins = [torch.tensor(x[k], device=cuda_device) for k in MIX_INPUTS]
    cots = [torch.tensor(x[k], device=cuda_device) for k in ("gq", "gmu")]
    for wgrad in (False, True):
        first = mix.mix_bwd_kernel(*ins, 1e-8, "ssp", *cots, wgrad=wgrad)
        for a, b in zip(first, mix.mix_bwd_kernel(*ins, 1e-8, "ssp", *cots,
                                                  wgrad=wgrad)):
            assert torch.equal(a, b)
    if B > 300:   # the message kernels' basis past their sweep
        return
    for wgrad in (False, True):
        first = schnet.cf_bwd_kernel(*args, refs, g, wgrad=wgrad)
        for a, b in zip(first, schnet.cf_bwd_kernel(*args, refs, g,
                                                    wgrad=wgrad)):
            assert torch.equal(a, b)
    m = message_case(F=F, B=B, seed=F + 1)
    t, mrefs, cw = torch_message_args(m, cuda_device)
    full = (t["x"], t["mu"], t["Rs"], t["FW"], t["coff_fm"], cw, mrefs,
            m["cutoff"], t["g_dq"], t["g_dmu"])
    for wgrad in (False, True):
        first = msg.msg_bwd_kernel(*full, wgrad=wgrad)
        for a, b in zip(first, msg.msg_bwd_kernel(*full, wgrad=wgrad)):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_general_forwards_take_a_basis_past_shared_memory(cuda_device):
    """At B = 60,000 (past the ~58,000 floats of one slot's basis row that
    a block's shared memory holds) the general message forward (K1, K6;
    F = 30) stages its chunks' basis rows in global scratch and K9 (F = 30,
    B + F > 58,000) runs its kScr instance; each matches its twin in
    float64 (``held``) on a small box."""
    F, B = 30, 60_000
    m = message_case(F=F, B=B, seed=5)
    t, refs, cw = torch_message_args(m, cuda_device)
    full = (t["x"], t["mu"], t["Rs"], t["FW"], t["coff_fm"], cw, refs,
            m["cutoff"])
    geo = geo_op.geo_fwd_kernel(t["Rs"], t["coff_fm"], refs, cw, m["cutoff"])
    before = dict(msg.LAUNCHES)
    for kern, plain, args in [
            (msg.msg_fwd_kernel, msg.msg_fwd_plain, full),
            (msg.msg_fwd_geo_kernel, msg.msg_fwd_geo_plain,
             (t["x"], t["mu"], geo, t["FW"], refs))]:
        held(kern(*args), plain(*args), f64(plain, *args), kern.__name__)
    assert {k: msg.LAUNCHES[k] - before[k] for k in before
            if msg.LAUNCHES[k] != before[k]} == {"msg_fwd_gen": 1,
                                                  "msg_fwd_geo_gen": 1}
    assert _build.query("spk_cf_gen_smem", F, B, 0) == 0   # kScr
    c = cfconv_case(F=F, B=B, seed=9, n=110, L=11.0)
    crefs = ColRefs.from_layout(c["lay"], device=cuda_device)
    args = [torch.tensor(c[k], device=cuda_device)
            for k in ("h", "geo", "W1", "b1", "W2", "b2")]
    args[2] = args[2] * B ** -0.5   # z1 of order 1
    fwd = lambda *a: (schnet.cf_fwd_plain(*a),)   # noqa: E731
    n = schnet.LAUNCHES["cf_fwd_gen"]
    held((schnet.cf_fwd_kernel(*args, crefs),), fwd(*args, crefs),
         f64(fwd, *args, crefs), "K9")
    assert schnet.LAUNCHES["cf_fwd_gen"] == n + 1


@pytest.mark.gpu
def test_cfconv_kernels_name_their_capacity(cuda_device):
    """No column capacity limits the cfconv kernels: K9 at B = 20 on P =
    222 (one past its old shared memory limit of 221) and P = 1000
    matches its twin, and K10 and its wgrad instance at P = 154 (past
    their old limit of 153) and P = 400 match the twin in float64.  A
    width the tuned kernels do not take (F = 96) runs the general
    instance: zeros in, zeros out."""
    F = 128
    c = cfconv_case(F=F, B=20, seed=3)
    base = ColRefs.from_layout(c["lay"], device=cuda_device)
    nx, ny = base.qcol.shape[:2]
    rng = np.random.RandomState(5)
    w = [torch.tensor(c[k], device=cuda_device)
         for k in ("geo", "W1", "b1", "W2", "b2")]

    def inputs(P):
        refs = dataclasses.replace(base, P=P, cache={})
        h, g = (torch.tensor(rng.randn(nx * ny * P, F).astype(np.float32),
                             device=cuda_device)
                for _ in range(2))
        return refs, h, g

    for P in (222, 1000):
        refs, h, _ = inputs(P)
        torch.testing.assert_close(schnet.cf_fwd_kernel(h, *w, refs),
                                   schnet.cf_fwd_plain(h, *w, refs),
                                   rtol=MSG_RTOL, atol=MSG_ATOL)
    for P in (154, 400):
        refs, h, g = inputs(P)
        _cfconv_bwd_checks([h, *w], refs, g)
    h96, W1, W2 = (torch.zeros(shape, device=cuda_device)
                   for shape in ((nx * ny * refs.P, 96), (20, 96), (96, 96)))
    b = torch.zeros(96, device=cuda_device)
    before = schnet.LAUNCHES["cf_fwd_gen"]
    out = schnet.cf_fwd_kernel(h96, w[0], W1, b, W2, b, refs)
    assert schnet.LAUNCHES["cf_fwd_gen"] == before + 1
    assert out.shape == h96.shape and not out.any()


#: threads (slots) of a narrow K11/K13 block
NARROW_BLOCK = 256


@pytest.mark.gpu
@pytest.mark.parametrize("D", [3, 36, 576, 13, 1, 2, 5, 7])
def test_select_kernels_match_twin(cuda_device, D):
    """K11-K14 at the positions' width, SO3net's 9 x F widths, an odd
    wide width (the scalar path) and the narrow widths 1-3, 5 and 7 (one
    slot a thread), on a Ktot that is no multiple of the narrow block; the
    copies K11/K13 equal their twins bit for bit."""
    c = message_case(seed=D % 7)
    refs = ColRefs.from_layout(c["lay"], device=cuda_device)
    nx, ny, Ktot = refs.qcol.shape
    assert Ktot % NARROW_BLOCK != 0
    g = torch.Generator().manual_seed(D)
    table = torch.randn((nx * ny * refs.P, D), generator=g).to(cuda_device)
    edges = torch.randn((nx, ny, Ktot, D), generator=g).to(cuda_device)
    for kern, plain, arg in [
            (sel.gather_fwd_kernel, sel.gather_fwd_plain, table),
            (sel.expand_fwd_kernel, sel.expand_fwd_plain, table)]:
        torch.testing.assert_close(kern(arg, refs), plain(arg, refs),
                                   rtol=0, atol=0)
    for kern, plain, arg in [
            (sel.gather_bwd_kernel, sel.gather_bwd_plain, edges),
            (sel.fold_fwd_kernel, sel.fold_fwd_plain, edges)]:
        torch.testing.assert_close(kern(arg, refs), plain(arg, refs),
                                   rtol=MSG_RTOL, atol=MSG_ATOL)
    # the autograd Functions pair them as the JAX custom_vjps do
    before = dict(sel.LAUNCHES)
    t = table.clone().requires_grad_(True)
    out = sel.column_fold_op(sel.column_gather_op(t, refs)
                             - sel.column_expand_op(t, refs), refs)
    out.backward(table)
    assert {k: sel.LAUNCHES[k] - before[k] for k in before} == {
        "gather_fwd": 1, "gather_bwd": 1, "expand_fwd": 2, "fold_fwd": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 384])
def test_select_kernels_on_the_bench_box_at_field_schnet_widths(cuda_device,
                                                                D):
    """K11-K14 at FieldSchNet-128's widths (D = F and 3F) on the column
    layout of the jittered 10,976-atom bench box: the copies bit for bit,
    the sums within the message tolerance."""
    R, cell = fcc_argon(14, jitter=0.1, seed=D)
    lay, _ = column_inputs(R, cell, 5.6)
    refs = ColRefs.from_layout(lay, device=cuda_device)
    nx, ny, Ktot = refs.qcol.shape
    g = torch.Generator().manual_seed(D)
    table = torch.randn((nx * ny * refs.P, D), generator=g).to(cuda_device)
    edges = torch.randn((nx, ny, Ktot, D), generator=g).to(cuda_device)
    for kern, plain, arg in [
            (sel.gather_fwd_kernel, sel.gather_fwd_plain, table),
            (sel.expand_fwd_kernel, sel.expand_fwd_plain, table)]:
        torch.testing.assert_close(kern(arg, refs), plain(arg, refs),
                                   rtol=0, atol=0)
    for kern, plain, arg in [
            (sel.gather_bwd_kernel, sel.gather_bwd_plain, edges),
            (sel.fold_fwd_kernel, sel.fold_fwd_plain, edges)]:
        torch.testing.assert_close(kern(arg, refs), plain(arg, refs),
                                   rtol=MSG_RTOL, atol=MSG_ATOL)


@pytest.mark.gpu
def test_field_schnet_on_the_card_matches_the_plain_route(cuda_device):
    """FieldSchNet-128x5 (seeded weights, the zero-initialised dipole
    filters perturbed, an electric field) on a 108-atom box: energy and
    forces through K11-K14 on the card against the twins' route on the
    CPU, and one force evaluation's launches (K11 16, K12 14, K13 16, K14
    16)."""
    from schnetpack_tpu_torch.atomistic import (
        Atomwise, Forces, PairwiseDistances,
    )
    from schnetpack_tpu_torch.model import NeuralNetworkPotential
    from schnetpack_tpu_torch.representation import FieldSchNet

    gen = torch.Generator().manual_seed(0)
    pot = NeuralNetworkPotential(
        FieldSchNet(128, 5, 20, 5.0, generator=gen),
        [Atomwise(n_in=128, generator=gen), Forces()],
        input_modules=[PairwiseDistances()]).requires_grad_(False)
    for block in pot.representation.dipole_inter:
        block.filter_electric_field_1.weight.normal_(generator=gen)
    R, cell = fcc_argon(3, jitter=0.3, seed=1, stretch=1.1)
    _, inputs = column_inputs(R, cell, 5.6)
    inputs[TP.electric_field] = torch.tensor([[0.1, -0.2, 0.3]])
    want = pot(dict(inputs))
    dev = {k: v.to(cuda_device) if torch.is_tensor(v) else v
           for k, v in inputs.items()}
    pot.to(cuda_device)
    before = dict(sel.LAUNCHES)
    got = pot(dev)
    assert {k: sel.LAUNCHES[k] - before[k] for k in before} == {
        "gather_fwd": 16, "gather_bwd": 14, "expand_fwd": 16,
        "fold_fwd": 16}
    torch.testing.assert_close(got[TP.energy].cpu(), want[TP.energy],
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(got[TP.forces].cpu(), want[TP.forces],
                               rtol=MSG_RTOL, atol=MSG_ATOL)
    assert float(want[TP.forces].abs().max()) > 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("P", [500, 1000])
def test_fold_kernel_tiles_rows_past_shared_memory(cuda_device, P):
    """K14 at capacities whose [P, 128] column sums would not fit a
    block's shared memory (P > 453 at D = 576), which the per-row sums on
    the destination runs never hold, held to the twin; also as the
    expand's VJP."""
    nx, ny, Ktot, D = 2, 2, 700, 576
    rng = np.random.RandomState(P)
    dcol = rng.randint(0, P, size=(nx, ny, Ktot)).astype(np.int32)
    dcol[rng.rand(nx, ny, Ktot) < 0.2] = -1
    dcol[0, 0, :3] = (0, P - 1, P // 2)     # the first and last rows
    ksizes = (80,) * 8 + (Ktot - 640,)
    t = torch.as_tensor(dcol, device=cuda_device)
    refs = ColRefs(t, t, P, ksizes)
    edges = torch.as_tensor(rng.randn(nx, ny, Ktot, D).astype(np.float32),
                            device=cuda_device)
    want = sel.fold_fwd_plain(edges, refs)
    torch.testing.assert_close(sel.fold_fwd_kernel(edges, refs), want,
                               rtol=MSG_RTOL, atol=MSG_ATOL)
    table = torch.zeros((nx * ny * P, D), device=cuda_device,
                        requires_grad=True)
    (dT,) = torch.autograd.grad(sel.column_expand_op(table, refs), table,
                                edges)
    torch.testing.assert_close(dT, want, rtol=MSG_RTOL, atol=MSG_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1100, 1500])
def test_geo_bwd_kernel_takes_any_capacity(cuda_device, P):
    """K8 at capacities above 1,052, where its per-column [9][P][3] shared
    sums asked for more than a block's 227 KB and failed at launch; the
    per-row sums on the source and destination runs hold no per-P state.
    Held to the twin, on a layout with empty rows and padded slots."""
    c = wide_column_case(P, seed=P)
    refs = ColRefs(torch.tensor(c["qcol"], device=cuda_device),
                   torch.tensor(c["dcol"], device=cuda_device), P,
                   c["ksizes"])
    cw = gaussian_rbf_table(12, 3.0, device=cuda_device)
    gargs = (torch.tensor(c["Rs"], device=cuda_device),
             torch.tensor(c["coff_fm"], device=cuda_device), refs, cw, 3.0)
    nx, ny, Ktot = refs.qcol.shape
    g = torch.randn((nx, ny, 16, Ktot),
                    generator=torch.Generator().manual_seed(P))
    g = g.to(cuda_device)
    torch.testing.assert_close(geo_op.geo_bwd_kernel(g, *gargs),
                               geo_op.geo_bwd_plain(g, *gargs),
                               rtol=MSG_RTOL, atol=MSG_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [3, 9, 576])
def test_fold_kernel_on_empty_rows(cuda_device, D):
    """K14 at the positions' width, an odd width (the scalar path) and
    SO3net's 9 x 64, on a layout whose column 0 has no real slot and
    whose rows past each column's atoms have none: those rows are 0 and
    the others match the twin."""
    c = wide_column_case(200, seed=D, Ktot=700, n_atoms=150)
    drop = np.zeros(c["qcol"].shape, bool)
    drop[0, 0] = True
    qcol = np.where(drop, -1, c["qcol"])
    dcol = np.where(drop, -1, c["dcol"])
    refs = ColRefs(torch.tensor(qcol, device=cuda_device),
                   torch.tensor(dcol, device=cuda_device), 200, c["ksizes"])
    edges = torch.randn((3, 3, 700, D),
                        generator=torch.Generator().manual_seed(D))
    edges = edges.to(cuda_device)
    got = sel.fold_fwd_kernel(edges, refs)
    torch.testing.assert_close(got, sel.fold_fwd_plain(edges, refs),
                               rtol=MSG_RTOL, atol=MSG_ATOL)
    rows = got.view(9, 200, D)
    assert bool((rows[0] == 0).all()) and bool((rows[:, 150:] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 3])
def test_fold_and_geo_bwd_kernels_are_deterministic(cuda_device, seed):
    """K14 (at D = 3 and 576) and K8 give bitwise equal outputs on two
    calls: each output row has one writer and a fixed order of sums."""
    c = message_case(seed=seed)
    t, refs, cw = torch_message_args(c, cuda_device)
    nx, ny, Ktot = refs.qcol.shape
    gen = torch.Generator().manual_seed(seed)
    for D in (3, 576):
        edges = torch.randn((nx, ny, Ktot, D), generator=gen).to(cuda_device)
        first = sel.fold_fwd_kernel(edges, refs)
        torch.testing.assert_close(sel.fold_fwd_kernel(edges, refs), first,
                                   rtol=0, atol=0)
    g = torch.randn((nx, ny, c["B"] + 4, Ktot), generator=gen)
    g = g.to(cuda_device)
    gargs = (t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    first = geo_op.geo_bwd_kernel(g, *gargs)
    torch.testing.assert_close(geo_op.geo_bwd_kernel(g, *gargs), first,
                               rtol=0, atol=0)


def mode_case(grid, mode, dev, F=32, B=8, seed=0):
    """``slab_case`` on ``dev`` with refs in the source-index ``mode`` and
    xmu over that mode's source table (the one-shard halo of the slab's
    xmu)."""
    c = slab_case(grid, F, B, seed)
    refs = dataclasses.replace(ColRefs.from_layout(c["lay"], device=dev),
                               shard_axis=MODES[mode])
    t = {k: torch.tensor(c[k], device=dev) for k in c if k != "lay"}
    if mode != "wrap":
        t["xmu"] = _halo_table(t["xmu"], refs).contiguous()
    return refs, t


@pytest.mark.gpu
@pytest.mark.parametrize("mode,grid,F,B", [
    ("wrap", (3, 3), 32, 8), ("wrap", (2, 3), 128, 8),
    ("halo_x", (3, 3), 128, 8), ("halo_x", (2, 3), 32, 8),
    ("halo_xy", (3, 3), 32, 8), ("halo_xy", (2, 2), 128, 8),
    ("wrap", (3, 3), 64, 20), ("halo_x", (2, 3), 64, 20),
    ("halo_xy", (3, 3), 64, 20), ("wrap", (2, 3), 256, 20),
    ("halo_x", (3, 3), 256, 20), ("halo_xy", (2, 2), 256, 20),
    ("halo_x", (3, 3), 128, 20), ("halo_xy", (3, 3), 64, 40),
    ("halo_x", (3, 3), 128, 27), ("wrap", (3, 3), 30, 20),
    ("halo_x", (2, 3), 30, 20), ("halo_xy", (3, 3), 288, 20),
    ("wrap", (2, 3), 512, 20), ("halo_x", (3, 3), 30, 50)])
def test_edge_kernels_match_twin(cuda_device, mode, grid, F, B):
    """K20, K21 and K21's wgrad instance (gFW held to the twin in f64) in
    each source-index mode, on aliased (2) and plain grids, at F = 32 to
    256 in the tuned bodies and at F = 30, 288 and 512 and B+1 > 32 in the
    general instances; the op launches the wgrad instance when FW_aug
    requires grad.  At B = 27 the filter weights are read through L1 (B+1
    > 24); at B = 40 and 50 (B+1 > 32) the general wgrad instance runs."""
    refs, t = mode_case(grid, mode, cuda_device, F=F, B=B, seed=sum(grid))
    args = (t["xmu"], t["rbf"], t["dir"], t["FW"], refs)
    cots = (t["g_dq"], t["g_dmu"])
    for g, w in zip(edge.msg_fwd_edge_kernel(*args),
                    edge.msg_fwd_edge_plain(*args)):
        torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    want = f64(edge.msg_bwd_edge_plain, *args, *cots)
    got = edge.msg_bwd_edge_kernel(*args, *cots)
    assert len(got) == 3
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    got = edge.msg_bwd_edge_kernel(*args, *cots, wgrad=True)
    assert len(got) == 4
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    before = dict(edge.LAUNCHES)
    ins = [a.clone().requires_grad_(True) for a in args[:4]]
    grads = torch.autograd.grad(edge.PaiNNMessageEdge.apply(*ins, refs),
                                ins, cots)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    fwd = "msg_fwd_edge" if msg.tuned_width(F, B) else "msg_fwd_edge_gen"
    wg = ("msg_bwd_edge_wgrad" if msg.tuned_width(F, B, True)
          else "msg_bwd_edge_wgrad_gen")
    assert {k: edge.LAUNCHES[k] - before[k] for k in before
            if edge.LAUNCHES[k] != before[k]} == {fwd: 1, wg: 1}


@pytest.mark.gpu
@pytest.mark.parametrize("mode,grid,D", [
    ("halo_x", (3, 3), 3), ("halo_x", (2, 3), 13), ("halo_xy", (2, 2), 3),
    ("halo_xy", (3, 3), 768),
    ("halo_x", (3, 3), 1), ("halo_x", (2, 3), 2), ("halo_x", (2, 3), 3),
    ("halo_x", (3, 3), 5), ("halo_x", (2, 2), 7),
    ("halo_xy", (3, 3), 1), ("halo_xy", (2, 3), 2), ("halo_xy", (3, 3), 3),
    ("halo_xy", (2, 2), 5), ("halo_xy", (2, 3), 7),
    ("wrap", (2, 3), 3), ("wrap", (2, 2), 5), ("wrap", (2, 2), 1)])
def test_halo_gather_kernels_match_twin(cuda_device, mode, grid, D):
    """K11 and K12 in each source-index mode (the halo modes, and the wrap
    on aliased grids) against the gather of that mode and its transpose,
    and the gather op (for the halo modes the sharded one: halo, K11; K12,
    folded back); the narrow widths (D < 8, D % 4 != 0) take the one slot
    a thread K11, on Ktots that are no multiple of its block."""
    refs, _ = mode_case(grid, mode, cuda_device)
    nx, ny, Ktot = refs.qcol.shape
    assert Ktot % NARROW_BLOCK != 0
    g = torch.Generator().manual_seed(D)
    table = torch.randn((refs.src_rows, D), generator=g).to(cuda_device)
    edges = torch.randn((nx, ny, Ktot, D), generator=g).to(cuda_device)
    torch.testing.assert_close(sel.gather_fwd_kernel(table, refs),
                               sel.gather_fwd_plain(table, refs),
                               rtol=0, atol=0)
    torch.testing.assert_close(sel.gather_bwd_kernel(edges, refs),
                               sel.gather_bwd_plain(edges, refs),
                               rtol=MSG_RTOL, atol=MSG_ATOL)
    before = dict(sel.LAUNCHES)
    t = table[:nx * ny * refs.P].clone().requires_grad_(True)
    (dT,) = torch.autograd.grad(sel.column_gather_op(t, refs), t, edges)
    tc = t.detach().cpu().requires_grad_(True)
    refs_cpu = dataclasses.replace(refs, qcol=refs.qcol.cpu(),
                                   dcol=refs.dcol.cpu(), cache={})
    (want,) = torch.autograd.grad(sel.column_gather_op(tc, refs_cpu), tc,
                                  edges.cpu())
    torch.testing.assert_close(dT.cpu(), want, rtol=MSG_RTOL, atol=MSG_ATOL)
    assert {k: sel.LAUNCHES[k] - before[k] for k in before} == {
        "gather_fwd": 1, "gather_bwd": 1, "expand_fwd": 0, "fold_fwd": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["aliased", "nz1"])
@pytest.mark.parametrize("D", [3, 13, 768, 1, 2, 5])
def test_cell_gather_kernels_match_twin(cuda_device, D, grid):
    """K16 and K17 at the positions' width, an odd width (the scalar path),
    PaiNN's xmu width 6 x 128 and the narrow widths 1, 2 and 5, on an
    aliased 2-cell grid and a grid with nz = 1, and the op pairing them:
    K16 (a copy) equals its twin bit for bit, and at the narrow widths
    K17 (the narrow row sums) equals their walk bit for bit."""
    c = cell_case(seed=D % 5, dims=(2, 2, 1) if grid == "nz1" else None)
    refs = cg.CellRefs(torch.tensor(c["qidx"], device=cuda_device))
    assert (refs.dims[2] == 1) == (grid == "nz1")
    Ap, K = c["lay"].nbh_idx.shape
    g = torch.Generator().manual_seed(D)
    table = torch.randn((Ap, D), generator=g).to(cuda_device)
    edges = torch.randn((Ap, K, D), generator=g).to(cuda_device)
    torch.testing.assert_close(cg.cell_gather_fwd_kernel(table, refs),
                               cg.cell_gather_plain(table, refs),
                               rtol=0, atol=0)
    dT = cg.cell_gather_bwd_kernel(edges, refs)
    torch.testing.assert_close(dT, cg.cell_gather_bwd_plain(edges, refs),
                               rtol=MSG_RTOL, atol=MSG_ATOL)
    if D % 4 != 0 and D < 8:
        esorted, _, rowptr = cg.source_order(refs)
        walk = narrow_row_sum_walk(edges.view(-1, D).cpu(), esorted.cpu(),
                                   rowptr.cpu(), sel.ROW_LANES)[0]
        torch.testing.assert_close(dT.cpu(), walk, rtol=0, atol=0)
    before = dict(cg.LAUNCHES)
    t = table.clone().requires_grad_(True)
    (dT,) = torch.autograd.grad(cg.cell_gather(t, refs), t, edges)
    torch.testing.assert_close(dT, cg.cell_gather_bwd_plain(edges, refs),
                               rtol=MSG_RTOL, atol=MSG_ATOL)
    assert {k: cg.LAUNCHES[k] - before[k] for k in before} == {
        "cell_gather_fwd": 1, "cell_gather_bwd": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["columns", "P1100"])
@pytest.mark.parametrize("D", [1, 2, 3, 5])
def test_narrow_row_sums_match_twin_and_walk(cuda_device, D, case):
    """K12 and K14 at the narrow widths (a group of ``ROW_LANES`` lanes a
    row) on a column layout and at P = 1,100 (above the 1,052 rows that
    K8's shared sums once capped): each within the message tolerance of
    its twin and bit for bit equal to the walk of its lane split and
    shuffle order on its order's runs, and equal over two calls."""
    if case == "columns":
        refs = ColRefs.from_layout(message_case(seed=D)["lay"],
                                   device=cuda_device)
    else:
        c = wide_column_case(1100, seed=D)
        refs = ColRefs(torch.tensor(c["qcol"], device=cuda_device),
                       torch.tensor(c["dcol"], device=cuda_device), 1100,
                       c["ksizes"])
    nx, ny, Ktot = refs.qcol.shape
    edges = torch.randn((nx, ny, Ktot, D),
                        generator=torch.Generator().manual_seed(D))
    edges = edges.to(cuda_device)
    for kern, plain, order in [
            (sel.gather_bwd_kernel, sel.gather_bwd_plain, source_order),
            (sel.fold_fwd_kernel, sel.fold_fwd_plain, destination_order)]:
        got = kern(edges, refs)
        torch.testing.assert_close(got, plain(edges, refs), rtol=MSG_RTOL,
                                   atol=MSG_ATOL)
        sorted_slots, _, rowptr = order(refs)
        walk = narrow_row_sum_walk(edges.view(-1, D).cpu(),
                                   sorted_slots.cpu(), rowptr.cpu(),
                                   sel.ROW_LANES)[0]
        torch.testing.assert_close(got.cpu(), walk, rtol=0, atol=0)
        torch.testing.assert_close(kern(edges, refs), got, rtol=0, atol=0)


#: the cell message cases: an aliased 2-cell grid and a 3-cell grid per
#: axis (``cell_case`` boxes)
CELL_GRIDS = {2: {}, 3: dict(n=200, L=13.0)}


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [2, 3])
@pytest.mark.parametrize("F,B", [(64, 20), (128, 20), (256, 20), (64, 27),
                                 (128, 27), (256, 27), (30, 20), (288, 20),
                                 (30, 50)])
def test_cell_message_kernels_match_twin(cuda_device, F, B, grid):
    """K18, K19 and K19's wgrad instance (the column bodies in the cell
    index mode) at F = 64-256, with the filter weights in registers (B+1 =
    21) and read through L1 (B+1 = 28), on an aliased and a 3-cell grid:
    gFW (an f32 sum per block of the slots' terms, blocks summed in f64)
    is held to the twin in float64, elementwise and normwise.  At F = 256
    and B+1 = 28 the tuned wgrad instance's f64 partial [B+1, 3F] and its
    tiles exceed a block's shared memory, and the general instance runs,
    as at F = 30 and 288 and B+1 = 51.  One forward and one backward
    through the op bump only the two cell counters of the instances that
    take the shape (the wgrad instance when FW_aug requires grad)."""
    c = cell_case(F=F, B=B, seed=F + B + grid, **CELL_GRIDS[grid])
    assert max(c["qidx"].shape[:3]) == grid
    refs = cg.CellRefs(torch.tensor(c["qidx"], device=cuda_device))
    t = [torch.tensor(c[k], device=cuda_device)
         for k in ("xmu", "rbf", "dir", "FW")]
    cots = [torch.tensor(c[k], device=cuda_device) for k in ("g_dq", "g_dmu")]
    for got, want in zip(pf.cell_msg_fwd_kernel(*t, refs),
                         pf.cell_msg_fwd_plain(*t, refs)):
        torch.testing.assert_close(got, want, rtol=MSG_RTOL, atol=MSG_ATOL)
    want = pf.cell_msg_bwd_plain(*t, refs, *cots)
    got = pf.cell_msg_bwd_kernel(*t, refs, *cots)
    assert len(got) == 3
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    want64 = f64(pf.cell_msg_bwd_plain, *t, refs, *cots)
    got = pf.cell_msg_bwd_kernel(*t, refs, *cots, wgrad=True)
    assert len(got) == 4
    for g, w in zip(got, want64):
        torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    assert_normwise(got[3], want64[3], "gFW")
    counters = (pf.LAUNCHES, msg.LAUNCHES, edge.LAUNCHES)
    before = [dict(c) for c in counters]
    ins = [a.clone().requires_grad_(True) for a in t]
    grads = torch.autograd.grad(pf.painn_message_cellblock(*ins, refs),
                                ins, cots)
    for g, w in zip(grads, want64):
        torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL)
    assert_normwise(grads[3], want64[3], "gFW (op)")
    moved = {k: v - b[k] for c, b in zip(counters, before)
             for k, v in c.items() if v != b[k]}
    # the tuned wgrad instance's f64 partial [B+1, 3F] and tiles exceed a
    # block's shared memory at F = 256, B+1 = 28: the general one runs
    tuned = (msg.tuned_width(F, B) and not (F == 256 and B == 27))
    fwd = "cell_msg_fwd" if msg.tuned_width(F, B) else "cell_msg_fwd_gen"
    assert moved == {fwd: 1,
                     "cell_msg_bwd" if tuned else "cell_msg_bwd_gen": 1}


@pytest.mark.gpu
def test_load_molecules_defaults_to_the_card(cuda_device):
    mol = {TP.Z: np.full(2, 18, np.int64), TP.R: np.eye(2, 3)}
    system = load_molecules([mol])
    assert system.positions.is_cuda and system.masses.is_cuda
