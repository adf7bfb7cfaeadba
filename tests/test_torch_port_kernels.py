"""PyTorch port: the CUDA kernels K1-K15 against their plain PyTorch twins,
on a card only (skipped without CUDA), and the entry points' default
device.  No jax import: on a machine
without jax run ``python -m pytest --noconftest -m gpu
tests/test_torch_port_kernels.py``."""
import numpy as np
import pytest
import torch

from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.md import load_molecules
from schnetpack_tpu_torch.ops import colblock_geo as geo_op
from schnetpack_tpu_torch.ops import colblock_select as sel
from schnetpack_tpu_torch.ops import colblock_message as msg
from schnetpack_tpu_torch.ops import painn_mixing as mix
from schnetpack_tpu_torch.ops import schnet_columns as schnet
from schnetpack_tpu_torch.ops.colblock import ColRefs
from torch_port_cases import (
    MIX_ATOL, MIX_INPUTS, MIX_RTOL, MSG_ATOL, MSG_RTOL, cfconv_case,
    message_case, mixing_case, torch_message_args,
)


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
    with pytest.raises(NotImplementedError, match="filter-weight"):
        schnet.schnet_cfconv_columns(*args[:2], args[2].requires_grad_(True),
                                     *args[3:], refs)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [3, 36, 576, 13])
def test_select_kernels_match_twin(cuda_device, D):
    """K11-K14 at the positions' width, SO3net's 9 x F widths, and an odd
    width (the scalar path)."""
    c = message_case(seed=D % 7)
    refs = ColRefs.from_layout(c["lay"], device=cuda_device)
    nx, ny, Ktot = refs.qcol.shape
    g = torch.Generator().manual_seed(D)
    table = torch.randn((nx * ny * refs.P, D), generator=g).to(cuda_device)
    edges = torch.randn((nx, ny, Ktot, D), generator=g).to(cuda_device)
    for kern, plain, arg in [
            (sel.gather_fwd_kernel, sel.gather_fwd_plain, table),
            (sel.expand_fwd_kernel, sel.expand_fwd_plain, table),
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
def test_load_molecules_defaults_to_the_card(cuda_device):
    mol = {TP.Z: np.full(2, 18, np.int64), TP.R: np.eye(2, 3)}
    system = load_molecules([mol])
    assert system.positions.is_cuda and system.masses.is_cuda
