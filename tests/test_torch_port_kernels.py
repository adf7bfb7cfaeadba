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
from schnetpack_tpu_torch.ops import cellblock_gather as cg
from schnetpack_tpu_torch.ops import colblock_edge as edge
from schnetpack_tpu_torch.ops import colblock_geo as geo_op
from schnetpack_tpu_torch.ops import colblock_select as sel
from schnetpack_tpu_torch.ops import colblock_message as msg
from schnetpack_tpu_torch.ops import painn_fused as pf
from schnetpack_tpu_torch.ops import painn_mixing as mix
from schnetpack_tpu_torch.ops import schnet_columns as schnet
from schnetpack_tpu_torch.ops.colblock import ColRefs
from schnetpack_tpu_torch.ops.colblock_shard import (
    COLS_AXIS, COLS_AXIS_Y, _halo_table,
)
from schnetpack_tpu_torch.ops.radial import gaussian_rbf_table
from torch_port_cases import (
    MIX_ATOL, MIX_INPUTS, MIX_RTOL, MSG_ATOL, MSG_RTOL, cell_case,
    cfconv_case, message_case, mixing_case, slab_case, torch_message_args,
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
def test_message_kernels_take_a_wide_basis(cuda_device):
    """B = 40 (B+1 > 32: the instance that reads the filter weights
    through L1): the forwards and the plain backwards match their twins;
    the wgrad instances still refuse B+1 > 32."""
    c = message_case(F=64, B=40, seed=7)
    _check_message_family(c, cuda_device, wgrad=False)
    t, refs, cw = torch_message_args(c, cuda_device)
    with pytest.raises(ValueError, match="B\\+1 <= 32"):
        msg.msg_bwd_kernel(t["x"], t["mu"], t["Rs"], t["FW"], t["coff_fm"],
                           cw, refs, c["cutoff"], t["g_dq"], t["g_dmu"],
                           wgrad=True)


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
@pytest.mark.parametrize("A,F,act", [(37, 32, "ssp"), (1000, 128, "silu"),
                                     (12800, 128, "ssp")])
def test_mixing_wgrad_instance_matches_twin(cuda_device, A, F, act):
    """K4's wgrad instance: the input cotangents equal the plain
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
    assert {k: mix.LAUNCHES[k] - before[k] for k in before} == {
        "mix_fwd": 2, "mix_bwd": 1, "mix_bwd_wgrad": 1}


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
        "msg_fwd": 0, "msg_bwd": 0, "msg_fwd_geo": 1, "msg_bwd_geores": 0,
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
        "msg_fwd": 1, "msg_bwd": 1, "msg_fwd_geo": 1, "msg_bwd_geores": 1,
        "msg_bwd_src": 0}


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
@pytest.mark.parametrize("seed", [3, 21])
def test_cfconv_kernels_match_twin(cuda_device, seed):
    """K9 and K10 (the kernels' width, F = 128) on synthetic raw-phi
    geometry."""
    c = cfconv_case(F=schnet.N_FILTERS, B=20, seed=seed)
    refs = ColRefs.from_layout(c["lay"], device=cuda_device)
    args = [torch.tensor(c[k], device=cuda_device)
            for k in ("h", "geo", "W1", "b1", "W2", "b2")]
    g = torch.tensor(c["g"], device=cuda_device)
    torch.testing.assert_close(schnet.cf_fwd_kernel(*args, refs),
                               schnet.cf_fwd_plain(*args, refs),
                               rtol=MSG_RTOL, atol=MSG_ATOL)
    for got, want in zip(schnet.cf_bwd_kernel(*args, refs, g),
                         schnet.cf_bwd_plain(*args, refs, g)[:2]):
        torch.testing.assert_close(got, want, rtol=MSG_RTOL, atol=MSG_ATOL)
    # the wgrad instance: also gW1, gb1, gW2, gb2, held to the twin in f64;
    # the op launches it when a filter weight requires grad
    want = f64(schnet.cf_bwd_plain, *args, refs, g)
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
    assert {k: schnet.LAUNCHES[k] - before[k] for k in before} == {
        "cf_fwd": 1, "cf_bwd": 0, "cf_bwd_wgrad": 1}


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
@pytest.mark.parametrize("P", [500, 1000])
def test_fold_kernel_tiles_rows_past_shared_memory(cuda_device, P):
    """K14 at a capacity whose [P, 128] column sums do not fit a block's
    shared memory (P > 453 at D = 576): the rows split into tiles (1000:
    two full tiles and a ragged one), held to the twin; also as the
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
    ("halo_x", (3, 3), 128, 27)])
def test_edge_kernels_match_twin(cuda_device, mode, grid, F, B):
    """K20, K21 and K21's wgrad instance (gFW held to the twin in f64) in
    each source-index mode, on aliased (2) and plain grids, at F = 32 to
    256; the op launches the wgrad instance when FW_aug requires grad.  At
    B = 27 the filter weights are read through L1 (B+1 > 24); at B = 40
    (B+1 > 32) the wgrad instance refuses, the others run."""
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
    if B + 1 > 32:
        with pytest.raises(ValueError, match="B\\+1 <= 32"):
            edge.msg_bwd_edge_kernel(*args, *cots, wgrad=True)
        return
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
    assert {k: edge.LAUNCHES[k] - before[k] for k in before} == {
        "msg_fwd_edge": 1, "msg_bwd_edge": 0, "msg_bwd_edge_wgrad": 1}


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
@pytest.mark.parametrize("D", [3, 13, 768])
def test_cell_gather_kernels_match_twin(cuda_device, D):
    """K16 and K17 at the positions' width, an odd width (the scalar path)
    and PaiNN's xmu width 6 x 128, on an aliased 2-cell grid, and the op
    pairing them."""
    c = cell_case(seed=D % 5)
    refs = cg.CellRefs(torch.tensor(c["qidx"], device=cuda_device))
    Ap, K = c["lay"].nbh_idx.shape
    g = torch.Generator().manual_seed(D)
    table = torch.randn((Ap, D), generator=g).to(cuda_device)
    edges = torch.randn((Ap, K, D), generator=g).to(cuda_device)
    torch.testing.assert_close(cg.cell_gather_fwd_kernel(table, refs),
                               cg.cell_gather_plain(table, refs),
                               rtol=MSG_RTOL, atol=MSG_ATOL)
    torch.testing.assert_close(cg.cell_gather_bwd_kernel(edges, refs),
                               cg.cell_gather_bwd_plain(edges, refs),
                               rtol=MSG_RTOL, atol=MSG_ATOL)
    before = dict(cg.LAUNCHES)
    t = table.clone().requires_grad_(True)
    (dT,) = torch.autograd.grad(cg.cell_gather(t, refs), t, edges)
    torch.testing.assert_close(dT, cg.cell_gather_bwd_plain(edges, refs),
                               rtol=MSG_RTOL, atol=MSG_ATOL)
    assert {k: cg.LAUNCHES[k] - before[k] for k in before} == {
        "cell_gather_fwd": 1, "cell_gather_bwd": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 3])
def test_cell_message_kernels_match_twin(cuda_device, seed):
    """K18, K19 and K19's wgrad instance, whose gFW (an f32 sum per block
    of the edges' terms, blocks summed in f64) is held to the twin in
    float64; the op launches the wgrad instance when FW_aug requires
    grad."""
    c = cell_case(F=128, B=20, seed=seed)
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
    want64 = pf.cell_msg_bwd_plain(*[a.double() for a in t], refs,
                                   *[a.double() for a in cots])
    got = pf.cell_msg_bwd_kernel(*t, refs, *cots, wgrad=True)
    assert len(got) == 4
    for g, w in zip(got, want64):
        torch.testing.assert_close(g, w.float(), rtol=MSG_RTOL, atol=MSG_ATOL)
    before = dict(pf.LAUNCHES)
    ins = [a.clone().requires_grad_(True) for a in t]
    grads = torch.autograd.grad(pf.painn_message_cellblock(*ins, refs), ins,
                                cots)
    for g, w in zip(grads, want64):
        torch.testing.assert_close(g, w.float(), rtol=MSG_RTOL,
                                   atol=MSG_ATOL)
    assert {k: pf.LAUNCHES[k] - before[k] for k in before} == {
        "cell_msg_fwd": 1, "cell_msg_bwd": 1}


@pytest.mark.gpu
def test_load_molecules_defaults_to_the_card(cuda_device):
    mol = {TP.Z: np.full(2, 18, np.int64), TP.R: np.eye(2, 3)}
    system = load_molecules([mol])
    assert system.positions.is_cuda and system.masses.is_cuda
