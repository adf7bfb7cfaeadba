"""PyTorch port: a CPU model of K3's and K4's arithmetic, the PaiNN mixing
block and its VJP with every product in 3xTF32 one m16n8k8 step at a time
as ``rows_mma`` (``csrc/tf32_mma.cuh``) forms it (K3 with compensated
sums), against
``painn_mixing_xla`` and its ``jax.vjp`` at the bench model's width with
its first mixing block, and the forward also at a width K3 pads; the
same model with the tensor cores' accumulator carried over K and with one
TF32 pass, which it must tell apart; the plain twin's VJP at that width;
K3's padded weights; and the widths the mixing kernels take
(``ops/painn_mixing.py::tuned_width``)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu.ops.painn_mixing import painn_mixing_xla
from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
from schnetpack_tpu_torch.ops import _build
from schnetpack_tpu_torch.ops import painn_mixing as mix
from schnetpack_tpu_torch.ops.activations import ACTIVATIONS
from torch_port_cases import MIX_ATOL, MIX_INPUTS, MIX_RTOL, mixing_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "scripts", "assets", "bench_painn_argon.msgpack")
EPS = 1e-8
#: rows of the model's inputs
ROWS = 256


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tf32(x):
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to 10
    mantissa bits, ties away from zero (on the bit pattern: add half an
    ulp of TF32, clear the 13 bits below)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def rz32(x):
    """float64 ``x`` rounded to float32 toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def mma(c, a, b):
    """One ``mma.sync`` m16n8k8 step, ``c + a @ b`` over 8 TF32 columns,
    as modelled here: the products and their sum exact (float64), the
    result rounded to f32 toward zero (the tensor cores' accumulation is
    not rounded to nearest; NVIDIA does not document it)."""
    return rz32(c.double() + a.double() @ b.double())


def _split(a, b):
    """Both factors as a TF32 big part and a TF32 remainder."""
    ab, bb = tf32(a), tf32(b)
    return ab, bb, tf32(a - ab), tf32(b - bb)


def mm_3xtf32(a, b):
    """``a @ b`` as ``rows_mma`` forms it: per k-step of 8, the small
    cross terms and then the big product go into a fresh fragment
    (``mma`` three times), which is added to the f32 sum."""
    ab, bb, a_s, b_s = _split(a, b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        t = mma(torch.zeros_like(acc), a_s[:, s], bb[s])
        t = mma(t, ab[:, s], b_s[s])
        acc = acc + mma(t, ab[:, s], bb[s])
    return acc


def mm_3xtf32_comp(a, b):
    """``a @ b`` as ``rows_mma`` forms it with ``COMP`` (K3): each
    k-step's fresh fragment added to the f32 sum with Kahan's
    compensation."""
    ab, bb, a_s, b_s = _split(a, b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    comp = torch.zeros_like(acc)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        t = mma(torch.zeros_like(acc), a_s[:, s], bb[s])
        t = mma(t, ab[:, s], b_s[s])
        y = mma(t, ab[:, s], bb[s]) - comp
        total = acc + y
        comp = (total - acc) - y
        acc = total
    return acc


def mm_3xtf32_carried(a, b):
    """``a @ b`` in 3xTF32 with the tensor cores' accumulator carried over
    all of K (``mma`` into one fragment): the accumulation that
    ``rows_mma`` avoids."""
    ab, bb, a_s, b_s = _split(a, b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        acc = mma(acc, a_s[:, s], bb[s])
        acc = mma(acc, ab[:, s], b_s[s])
        acc = mma(acc, ab[:, s], bb[s])
    return acc


def mm_tf32(a, b):
    """``a @ b`` in one TF32 pass: what 3xTF32 adds precision to."""
    return tf32(a) @ tf32(b)


class _Product(torch.autograd.Function):
    """``mm(a, b)`` whose VJP is made of the same product, as K4's
    transposed products are."""

    @staticmethod
    def forward(ctx, a, b, mm):
        ctx.save_for_backward(a, b)
        ctx.mm = mm
        return mm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        need_a, need_b, _ = ctx.needs_input_grad
        return (ctx.mm(g, b.t()) if need_a else None,
                ctx.mm(a.t(), g) if need_b else None, None)


def mixing_model(qp, mup, kmix, k0, b0, k1, b1, act, mm):
    """The mixing block (``painn_mixing.py:48-70``) on q' = q + dq and
    mu' = mu + dmu with every product ``mm``."""
    F = qp.shape[1]

    def dot(a, b):
        return _Product.apply(a, b.contiguous(), mm)

    VW = [dot(m, kmix) for m in mup.split(F, dim=1)]
    V_c = [x[:, :F] for x in VW]
    W_c = [x[:, F:] for x in VW]
    Vn = torch.sqrt(V_c[0] ** 2 + V_c[1] ** 2 + V_c[2] ** 2 + EPS)
    h = ACTIVATIONS[act](dot(qp, k0[:F]) + dot(Vn, k0[F:]) + b0)
    dq_i, dmu_i, dqmu_i = (dot(h, k1) + b1).split(F, dim=1)
    vw = V_c[0] * W_c[0] + V_c[1] * W_c[1] + V_c[2] * W_c[2]
    q_out = qp + dq_i + dqmu_i * vw
    mu_out = torch.cat([m + dmu_i * w
                        for m, w in zip(mup.split(F, dim=1), W_c)], dim=1)
    return q_out, mu_out


def model_vjp(ins, cots, act, mm):
    """The model's cotangents of (q', mu'): K4's plain instance."""
    qp = (ins[0] + ins[2]).requires_grad_(True)
    mup = (ins[1] + ins[3]).requires_grad_(True)
    out = mixing_model(qp, mup, *ins[4:], act, mm)
    return torch.autograd.grad(out, (qp, mup), cots)


@pytest.fixture(scope="module")
def bench_case():
    """256 rows of random features and cotangents (numpy, seed 0, the
    scales of ``scripts/time_mixing_kernels.py``) with the trained
    PaiNN-128x3's first mixing block."""
    params = params_from_jax(load_jax_params(ASSET))
    w = [params[f"representation.mixing.0.{k}"].numpy()
         for k in ("kmix", "k0", "b0", "k1", "b1")]
    F = w[0].shape[0]
    rng = np.random.RandomState(0)

    def r(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype(np.float32)

    ins = [r(ROWS, F), r(ROWS, 3 * F, scale=0.3), r(ROWS, F, scale=0.3),
           r(ROWS, 3 * F, scale=0.3), *w]
    return ins, [r(ROWS, F), r(ROWS, 3 * F)]


def jax_vjp(ins, cots, act):
    _, vjp = jax.vjp(lambda *a: painn_mixing_xla(*a, EPS, act),
                     *[jnp.asarray(a) for a in ins])
    return [np.asarray(g, np.float64)
            for g in vjp(tuple(jnp.asarray(c) for c in cots))[:2]]


def jax_fwd(ins, act):
    return [np.asarray(o, np.float64)
            for o in painn_mixing_xla(*[jnp.asarray(a) for a in ins], EPS,
                                      act)]


def model_fwd(ins, act, mm):
    """The model's (q_out, mu_out): K3."""
    with torch.no_grad():
        return mixing_model(ins[0] + ins[2], ins[1] + ins[3], *ins[4:], act,
                            mm)


def max_miss(got, want):
    return max(float(np.abs(g.double().numpy() - w).max())
               for g, w in zip(got, want))


def test_tf32_rounds_to_nearest_away():
    """The model's rounding: 10 mantissa bits kept, ties away from zero,
    in both signs."""
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + ulp, 3.0]
    assert tf32(x).tolist() == want
    big = tf32(x)
    assert torch.equal(big + tf32(x - big), x)


@pytest.mark.parametrize("act", ["ssp", "silu"])
def test_3xtf32_model_vjp_matches_jax(bench_case, act):
    """The mixing VJP through 3xTF32 products, at F = 128 on the bench
    weights, against ``jax.vjp`` of ``painn_mixing_xla`` within the
    mixing tolerances (f32 sums over K up to 3F = 384)."""
    ins, cots = bench_case
    want = jax_vjp(ins, cots, act)
    got = model_vjp([torch.tensor(a) for a in ins],
                    [torch.tensor(c) for c in cots], act, mm_3xtf32)
    assert got[0].shape == (ROWS, 128)
    for name, g, w in zip(("q", "mu"), got, want):
        np.testing.assert_allclose(g.double().numpy(), w, MIX_RTOL, MIX_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("act", ["ssp", "silu"])
def test_one_tf32_pass_misses_by_10x_more(bench_case, act):
    """One TF32 pass on the same inputs misses JAX by at least 10x the
    3xTF32 model's max miss, so the model test tells them apart."""
    ins, cots = bench_case
    want = jax_vjp(ins, cots, act)
    t = [torch.tensor(a) for a in ins]
    c = [torch.tensor(x) for x in cots]
    three = max_miss(model_vjp(t, c, act, mm_3xtf32), want)
    one = max_miss(model_vjp(t, c, act, mm_tf32), want)
    assert one >= 10 * three, (one, three)


@pytest.mark.parametrize("act", ["ssp", "silu"])
def test_carried_accumulator_misses_by_5x_more(bench_case, act):
    """3xTF32 with the tensor cores' accumulator carried over K misses JAX
    by at least 5x the model's max miss on the same inputs (about 11x
    here), so the model tells ``rows_mma``'s fresh fragment per k-step
    from the accumulation that failed on the card."""
    ins, cots = bench_case
    want = jax_vjp(ins, cots, act)
    t = [torch.tensor(a) for a in ins]
    c = [torch.tensor(x) for x in cots]
    fresh = max_miss(model_vjp(t, c, act, mm_3xtf32), want)
    carried = max_miss(model_vjp(t, c, act, mm_3xtf32_carried), want)
    assert carried >= 5 * fresh, (carried, fresh)


@pytest.mark.parametrize("act", ["ssp", "silu"])
def test_plain_twin_vjp_at_bench_width_matches_jax(bench_case, act):
    """K4's twin at F = 128 with the bench weights (the other CPU parity
    tests run it at F = 32) against ``jax.vjp``."""
    ins, cots = bench_case
    want = jax_vjp(ins, cots, act)
    got = mix.painn_mixing_bwd_plain(*[torch.tensor(a) for a in ins], EPS,
                                     act, *[torch.tensor(c) for c in cots])
    for name, g, w in zip(MIX_INPUTS[:2], got, want):
        np.testing.assert_allclose(g.double().numpy(), w, MIX_RTOL, MIX_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("act", ["ssp", "silu"])
def test_3xtf32_model_forward_matches_jax(bench_case, act):
    """The mixing block through compensated 3xTF32 products (K3's
    arithmetic), at F = 128 on the bench weights, against
    ``painn_mixing_xla`` within the mixing tolerances."""
    ins, _ = bench_case
    want = jax_fwd(ins, act)
    got = model_fwd([torch.tensor(a) for a in ins], act, mm_3xtf32_comp)
    assert got[1].shape == (ROWS, 3 * 128)
    for name, g, w in zip(("q_out", "mu_out"), got, want):
        np.testing.assert_allclose(g.double().numpy(), w, MIX_RTOL, MIX_ATOL,
                                   err_msg=name)


def pad_blocks(x, blocks, FP):
    """[rows, blocks F] -> [rows, blocks FP], zero columns after each
    block's F: K3's row tiles as the kernel loads them."""
    F = x.shape[1] // blocks
    out = x.new_zeros((x.shape[0], blocks, FP))
    out[..., :F] = x.reshape(x.shape[0], blocks, F)
    return out.reshape(x.shape[0], -1)


@pytest.mark.parametrize("act", ["ssp", "silu"])
def test_3xtf32_model_forward_padded_matches_jax(act):
    """At F = 36 K3 pads to FP = 64: the model at FP, on the row tiles
    zero-padded as the kernel loads them and the wrapper's padded weights
    (``pad_weights``; Vn's padding columns, sqrt(eps), meet zero rows of
    k0), gives at the first F columns of each block what
    ``painn_mixing_xla`` gives at F = 36, within the mixing tolerances."""
    F = 36
    FP = mix.fwd_width(F)
    assert FP == 64
    c = mixing_case(A=64, F=F, seed=3)
    ins = [c[k] for k in MIX_INPUTS]
    want = jax_fwd(ins, act)
    t = [torch.tensor(a) for a in ins]
    w = mix.pad_weights(*t[4:])
    assert [tuple(x.shape) for x in w] == [(FP, 2 * FP), (2 * FP, FP), (FP,),
                                           (FP, 3 * FP), (3 * FP,)]
    with torch.no_grad():
        qo, muo = mixing_model(pad_blocks(t[0] + t[2], 1, FP),
                               pad_blocks(t[1] + t[3], 3, FP), *w, act,
                               mm_3xtf32_comp)
    got = (qo[:, :F], muo.reshape(-1, 3, FP)[..., :F].reshape(-1, 3 * F))
    for name, g, w in zip(("q_out", "mu_out"), got, want):
        np.testing.assert_allclose(g.double().numpy(), w, MIX_RTOL, MIX_ATOL,
                                   err_msg=name)


def test_pad_weights_pads_each_block():
    """K3's padded weights at F = 36: each block of F rows or columns holds
    the weights, followed by zeros up to FP = 64."""
    c = mixing_case(F=36)
    w = [torch.tensor(c[k]) for k in MIX_INPUTS[4:]]
    kmix, k0, b0, k1, b1 = mix.pad_weights(*w)
    for got, want, rb, cb in ((kmix, w[0], 1, 2), (k0, w[1], 2, 1),
                              (k1, w[3], 1, 3)):
        got = got.reshape(rb, 64, cb, 64)
        assert torch.equal(got[:, :36, :, :36], want.reshape(rb, 36, cb, 36))
        assert not got[:, 36:].any() and not got[..., 36:].any()
    for got, want, cb in ((b0, w[2], 1), (b1, w[4], 3)):
        got = got.reshape(cb, 64)
        assert torch.equal(got[:, :36], want.reshape(cb, 36))
        assert not got[:, 36:].any()


@pytest.mark.parametrize("F,bwd,ok", [
    (32, True, True), (256, True, True), (48, True, False),
    (288, True, False), (279, False, True), (352, False, True),
    (353, False, False), (48, False, True)])
def test_mixing_kernel_widths(F, bwd, ok):
    """Every width is taken: the tuned K4 takes F % 32 == 0 and F <= 256,
    the tuned K3 any F whose 16 rows of 10 FP + 16 floats (FP: F rounded
    up to 32) fit the opt-in shared memory limit (F <= 352); one past each
    (``ok`` False) runs the general instance, and the wrappers' check
    raises for no width F >= 1."""
    assert mix.mix_fwd_smem_bytes(F) == 64 * (10 * (-(-F // 32) * 32) + 16)
    assert mix.tuned_width(F, bwd) == ok
    mix.check_width(F)
    assert ok or bwd or mix.mix_fwd_smem_bytes(F) > _build.MAX_DYN_SMEM


# ------------------------------------------- the general instances' walks
#: rows a block of K4 (``csrc/painn_mixing_bwd_body.cuh::kBwdRows``) and
#: of a step of the wgrad reduction's f32 sums (``mix_wgrad.cuh::kWR``)
BWD_ROWS, WGRAD_STEP = 16, 32


def _act_np(act):
    return ACTIVATIONS[act]


def _dact(act, x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s)) if act == "silu" else s


def _gen_bwd_walk(ins, cots, act, nsplit=3, exact=False):
    """``csrc/painn_mixing_gen.cu::mix_bwd_gen_kernel`` and the weight
    cotangents it hands to ``mix_wgrad.cuh``: blocks of BWD_ROWS rows (the
    last one ragged) at the padded width FP = F rounded up to 32, on the
    rows zero-padded to it and the weights ``pad_weights`` gives, every
    product in the 3xTF32 model with Kahan-compensated sums
    (``mm_3xtf32_comp``, as every general instance), the elementwise
    steps in f32; each row's gq', gmu' and 16F factors [mu' | q' | Vn | h
    | gV | gW | gpre | gcat] (S) kept at the first F lanes, the padded
    ones asserted zeros (but Vn's sqrt(eps)); the reduction sums products
    of S's columns in f32 over WGRAD_STEP rows at a time and in float64
    over nsplit row ranges into [gkmix | gk0 | gb0 | gk1 | gb1] by ``mix_wgrad.cuh``'s
    problem table.  ``exact``: the same walk in float64, every product
    exact.  Returns (gqi, gmui, the five weight cotangents, how often each
    gqi and gmui row was written)."""
    dt = torch.float64 if exact else torch.float32
    q, mu, dq, dmu, kmix, k0, b0, k1, b1 = (torch.tensor(a).to(dt)
                                            for a in ins)
    gq, gmu = (torch.tensor(a).to(dt) for a in cots)
    A, F = q.shape
    FP = mix.fwd_width(F)
    w = mix.pad_weights(kmix, k0, b0, k1, b1) if F % 32 else (kmix, k0, b0,
                                                               k1, b1)
    kmixP, k0P, b0P, k1P, b1P = w
    kmixT, k0T, k1T = (t.t().contiguous() for t in (kmixP, k0P, k1P))
    mm = (torch.matmul if exact else mm_3xtf32_comp if FP > 256
          else mm_3xtf32)
    act_f = _act_np(act)

    def pad(x, blocks):
        return pad_blocks(x, blocks, FP) if FP != F else x

    def comps(x):   # [rows, 3FP] -> the three [rows, FP]
        return list(x.split(FP, dim=1))

    gqi, gmui = torch.zeros_like(q), torch.zeros_like(mu)
    n_rows = torch.zeros(A, dtype=torch.int64)
    S = torch.zeros(A, 16 * F, dtype=dt)
    for row0 in range(0, A, BWD_ROWS):
        rows = torch.arange(row0, min(A, row0 + BWD_ROWS))
        qp = pad(q[rows] + dq[rows], 1)
        mup = comps(pad(mu[rows] + dmu[rows], 3))
        VW = [mm(m, kmixP) for m in mup]
        V, W = [x[:, :FP] for x in VW], [x[:, FP:] for x in VW]
        Vn = torch.sqrt(V[0] ** 2 + V[1] ** 2 + V[2] ** 2 + EPS)
        pre = mm(torch.cat([qp, Vn], 1), k0P) + b0P
        h = act_f(pre)
        bc = mm(h, k1P[:, FP:].contiguous()) + b1P[FP:]
        b, c = bc[:, :FP], bc[:, FP:]
        g = pad(gq[rows], 1)
        gm = comps(pad(gmu[rows], 3))
        vw = V[0] * W[0] + V[1] * W[1] + V[2] * W[2]
        gW = [gm[i] * b + (g * c) * V[i] for i in range(3)]
        gV = [(g * c) * W[i] for i in range(3)]
        gdmu = gm[0] * W[0] + gm[1] * W[1] + gm[2] * W[2]
        gcat = torch.cat([g, gdmu, g * vw], 1)
        gpre = mm(gcat, k1T) * _dact(act, pre)
        back = mm(gpre, k0T)
        gqp = g + back[:, :FP]
        gV = [gV[i] + (back[:, FP:] / Vn) * V[i] for i in range(3)]
        gmp = [gm[i] + mm(torch.cat([gV[i], gW[i]], 1), kmixT)
               for i in range(3)]
        lanes = [gqp, *gmp, *mup, qp, Vn, h, *gV, *gW, gpre, g, gdmu,
                 g * vw]
        for x in lanes:   # the padded lanes: exact zeros but Vn = sqrt(eps)
            if x is not Vn:   # and act(0), 0 up to the log's rounding
                tol = 1e-7 if x is h else 0.0
                assert bool((x[:, F:].abs() <= tol).all())
        gqi[rows] = gqp[:, :F]
        gmui[rows] = torch.cat([x[:, :F] for x in gmp], 1)
        n_rows[rows] += 1
        S[rows] = torch.cat([x[:, :F] for x in lanes[4:]], 1)
    FF = F * F
    part = torch.zeros(nsplit, 7 * FF + 4 * F, dtype=torch.float64)
    # mix_wgrad.cuh's problems: (x_off, y_off, M, N, terms, step, out_off,
    # out_ld, bias_off)
    probs = [(0, 6 * F, F, F, 3, F, 0, 2 * F, -1),
             (0, 9 * F, F, F, 3, F, F, 2 * F, -1),
             (3 * F, 12 * F, 2 * F, F, 1, 0, 2 * FF, F, 4 * FF),
             (5 * F, 13 * F, F, 3 * F, 1, 0, 4 * FF + F, 3 * F, 7 * FF + F)]
    per = -(-A // nsplit)
    for sp in range(nsplit):
        Ss = S[sp * per:min(A, (sp + 1) * per)]
        for xo, yo, M, N, terms, step, oo, ld, bo in probs:
            acc = torch.zeros(M + 1, N, dtype=torch.float64)
            for t in range(terms):
                X = Ss[:, xo + t * step:xo + t * step + M]
                X = torch.cat([X, torch.ones_like(X[:, :1])], 1)
                Y = Ss[:, yo + t * step:yo + t * step + N]
                for r in range(0, X.shape[0], WGRAD_STEP):
                    acc += (X[r:r + WGRAD_STEP].t()
                            @ Y[r:r + WGRAD_STEP]).double()
            for i in range(M):
                part[sp, oo + i * ld:oo + i * ld + N] = acc[i]
            if bo >= 0:
                part[sp, bo:bo + N] = acc[M]
    wsum = part.sum(0)
    return (gqi, gmui, wsum[:2 * FF].view(F, 2 * F),
            wsum[2 * FF:4 * FF].view(2 * F, F), wsum[4 * FF:4 * FF + F],
            wsum[4 * FF + F:7 * FF + F].view(F, 3 * F), wsum[7 * FF + F:],
            n_rows)


@pytest.mark.parametrize("act", ["ssp", "silu"])
@pytest.mark.parametrize("F", [30, 288])
def test_general_backward_walk_matches_jax(F, act):
    """The general K4 (and its wgrad reduction) at F = 30 (FP = 32, two
    padded lanes) and 288 (FP = 288, past the shared memory's 256: the
    kScr instance) on 37 rows (the last block ragged):
    replayed with every product exact in float64 it matches the twin in
    float64 to 1e-9 (the summation orders differ); replayed in the
    kernel's arithmetic (the 3xTF32 model) it matches the twin and the JAX
    package's ``painn_mixing_xla`` VJP, both evaluated in float64 (x64),
    at the mixing tolerances, the weight cotangents normwise within 1e-5;
    every padded lane is an exact zero (but Vn = sqrt(eps) and act(0),
    within the log's rounding) and every row of gq' and gmu' is written
    exactly once."""
    c = mixing_case(A=37, F=F, seed=F)
    ins = [c[k] for k in MIX_INPUTS]
    cots = (c["gq"], c["gmu"])
    *got, n_rows = _gen_bwd_walk(ins, cots, act)
    *got64, _ = _gen_bwd_walk(ins, cots, act, exact=True)
    assert bool((n_rows == 1).all())
    t = [torch.tensor(a).double() for a in ins]
    twin = mix.painn_mixing_bwd_plain(*t, EPS, act,
                                      *(torch.tensor(a).double()
                                        for a in cots), wgrad=True)
    with jax.enable_x64(True):
        _, vjp = jax.vjp(lambda *a: painn_mixing_xla(*a, EPS, act),
                         *[jnp.asarray(a, jnp.float64) for a in ins])
        want = [np.asarray(g) for g in vjp(tuple(
            jnp.asarray(a, jnp.float64) for a in cots))]
    # the JAX VJP's cotangents of (q, mu, dq, dmu, kmix, k0, b0, k1, b1):
    # q's equals dq's (the residual), as the kernel's one gq'
    want = [want[0], want[1]] + want[4:]
    names = ("gq'", "gmu'", "gkmix", "gk0", "gb0", "gk1", "gb1")
    for i, (name, a, a64, w, j) in enumerate(zip(names, got, got64, twin,
                                                 want)):
        a, a64, w = a.double().numpy(), a64.numpy(), w.numpy()
        np.testing.assert_allclose(a64, w, 1e-9, 1e-11, err_msg=name)
        for ref in (w, j):
            if i < 2:
                np.testing.assert_allclose(a, ref, MIX_RTOL, MIX_ATOL,
                                           err_msg=name)
            else:   # sums over the rows: normwise, as the card's gates
                assert (np.linalg.norm(a - ref)
                        <= 1e-5 * np.linalg.norm(ref)), name


@pytest.mark.parametrize("act", ["ssp", "silu"])
def test_padded_weights_give_the_unpadded_backward(act):
    """K4's zero-padded weights (``pad_weights``, FP = 64 at F = 50) on
    inputs and cotangents zero-padded the same way give the unpadded
    twin's cotangents in float64, the weight cotangents at the real rows
    and columns of each block: on the padded lanes V = 0 and Vn =
    sqrt(eps), whose rows of k0 are zero, act(0) meets zero rows of k1, and
    gq' and gmu' there are exact zeros.  (The padded rows of gk0's Vn
    block are sqrt(eps) gpre, not 0: the kernel's wgrad reduction forms
    the cotangents at the unpadded F only.)"""
    F = 50
    FP = mix.fwd_width(F)
    assert FP == 64
    c = mixing_case(A=37, F=F, seed=7)
    t = [torch.tensor(c[k]).double() for k in MIX_INPUTS]
    cots = [torch.tensor(c[k]).double() for k in ("gq", "gmu")]
    want = mix.painn_mixing_bwd_plain(*t, EPS, act, *cots, wgrad=True)
    w = mix.pad_weights(*t[4:])
    blocks = (1, 3, 1, 3)
    got = mix.painn_mixing_bwd_plain(
        *(pad_blocks(x, n, FP) for x, n in zip(t[:4], blocks)), *w, EPS, act,
        pad_blocks(cots[0], 1, FP), pad_blocks(cots[1], 3, FP), wgrad=True)

    def real(x, rb, cb):   # [rb FP, cb FP] -> the real [rb F, cb F]
        x = x.reshape(rb, FP, cb, FP)[:, :F, :, :F]
        return x.reshape(rb * F, cb * F), x

    pairs = [(got[0][:, :F], want[0]),
             (got[1].reshape(-1, 3, FP)[..., :F].reshape(-1, 3 * F),
              want[1])]
    for g, wt, rb, cb in ((got[2], want[2], 1, 2), (got[3], want[3], 2, 1),
                          (got[5], want[5], 1, 3)):
        pairs.append((real(g, rb, cb)[0], wt))
    for g, wt, cb in ((got[4], want[4], 1), (got[6], want[6], 3)):
        pairs.append((g.reshape(cb, FP)[:, :F].reshape(-1), wt))
    assert not got[0][:, F:].any()
    assert not got[1].reshape(-1, 3, FP)[..., F:].any()
    for g, wt in pairs:
        np.testing.assert_allclose(g.numpy(), wt.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_bwd_weights_are_made_once_per_parameter_version():
    """``bwd_weights`` returns the same tensors (the padded weights and
    the transposed copies, here at F = 36) until an in-place update bumps
    a weight's version, and at F = 32 the weights themselves with their
    transposes."""
    c = mixing_case(F=36)
    weights = [torch.tensor(c[k]) for k in MIX_INPUTS[4:]]
    first = mix.bwd_weights(*weights)
    assert len(first) == 8 and first[0].shape == (64, 128)
    assert mix.bwd_weights(*weights) is first
    torch.testing.assert_close(first[5], first[0].t())
    torch.testing.assert_close(first[6], first[1].t())
    torch.testing.assert_close(first[7], first[3].t())
    with torch.no_grad():
        weights[3].mul_(2.0)             # a new parameter version
    again = mix.bwd_weights(*weights)
    assert again is not first and mix.bwd_weights(*weights) is again
    torch.testing.assert_close(again[3][:36, :36], weights[3][:, :36])
    torch.testing.assert_close(again[7], again[3].t())
    c32 = mixing_case(F=32)
    w32 = [torch.tensor(c32[k]) for k in MIX_INPUTS[4:]]
    got = mix.bwd_weights(*w32)
    assert all(a is b for a, b in zip(got[:5], w32))
    torch.testing.assert_close(got[5], w32[0].t())
