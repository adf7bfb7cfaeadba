"""Fused PaiNN mixing: CUDA kernels K3/K4 and their plain twin.

Counterpart of ``schnetpack_tpu/ops/painn_mixing.py``: the interaction
residual add and the whole intra-atomic mixing block run as one kernel
(K3, ``csrc/painn_mixing.cu::mix_fwd_kernel``, its products on the
tensor cores in 3xTF32); the backward (K4, ``mix_bwd_kernel``, likewise)
recomputes the forward and returns the input cotangents, and in its wgrad
instance also the weight cotangents, which the op launches when a mixing
weight requires grad (MD keeps the plain instance).  By the residual
identity the cotangents of q and dq (mu and dmu) are equal.  Unlike the
JAX wrapper there is no fallback for row counts without a dividing block:
the kernels mask the ragged tail.  The tuned K3 takes F <= ``FWD_MAX_F``
(with weights zero-padded to a multiple of 32, cached per parameter
version), the tuned K4 ``BWD_WIDTHS``; every other width runs the general
instances (``csrc/painn_mixing_gen.cu``, counted as ``mix_fwd_gen``,
``mix_bwd_gen`` and ``mix_bwd_wgrad_gen``), the general K4 the tuned
body on weights zero-padded to a multiple of 32.  K4's weights and their
transposed copies are made once per parameter version
(``bwd_weights``).

On CUDA tensors the op launches the kernels (or raises); on CPU tensors it
runs the plain twin (the math of ``_fwd_core``) under ordinary autograd.
"""
from __future__ import annotations

import torch

from . import _build
from .activations import ACTIVATIONS

#: kernel launches since the last reset (the main path adds one per call;
#: ``mix_bwd_wgrad`` counts K4's wgrad instance)
LAUNCHES = {"mix_fwd": 0, "mix_bwd": 0, "mix_bwd_wgrad": 0,
            "mix_fwd_gen": 0, "mix_bwd_gen": 0, "mix_bwd_wgrad_gen": 0}
_ACT_CODE = {"ssp": 0, "silu": 1}
#: rows a row range of the wgrad reduction (``csrc/mix_wgrad.cuh``), at
#: least
_WGRAD_ROWS = 256
#: the reduction's output tile edge (``kWT``)
_WGRAD_TILE = 64
#: the widths the tuned K4 takes: those of the tuned column message
#: kernels (``colblock_message.py``)
BWD_WIDTHS = "F % 32 == 0 and F <= 256"
#: K3 pads F to a multiple of this (``csrc/painn_mixing.cu::kFwdPad``)
FWD_PAD = 32
#: K3's rows a block (``kFwdRows``)
_FWD_ROWS = 16
#: the widest F whose K3 tiles fit the opt-in shared memory limit (352)
FWD_MAX_F = ((_build.MAX_DYN_SMEM // (4 * _FWD_ROWS) - 16) // 10
             // FWD_PAD * FWD_PAD)


def fwd_width(F: int) -> int:
    """FP: F rounded up to ``FWD_PAD``, K3's padded width and the general
    K4's (the tuned K4 takes F % 32 == 0, FP = F)."""
    return -(-F // FWD_PAD) * FWD_PAD


def wgrad_splits(A: int, F: int, sms: int) -> int:
    """Row ranges of K4's wgrad reduction at A rows and width F on a card
    of ``sms`` multiprocessors: about two blocks an SM over the
    reduction's 64 x 64 output tiles at F (``launch_mix_wgrad``'s problems:
    gWv and gWw [F, F], [gk0; gb0] [2F + 1, F], [gk1; gb1] [F + 1, 3F]),
    each range at least ``_WGRAD_ROWS`` rows."""
    def tiles(m, n):
        return -(-m // _WGRAD_TILE) * -(-n // _WGRAD_TILE)

    t = 2 * tiles(F, F) + tiles(2 * F + 1, F) + tiles(F + 1, 3 * F)
    return max(1, min(-(-A // _WGRAD_ROWS), -(-2 * sms // t)))


def mix_fwd_smem_bytes(F: int) -> int:
    """K3's dynamic shared memory: 16 rows of 10 FP + 16 floats (what
    ``csrc/painn_mixing.cu::spk_mix_smem_bytes`` gives its launch, which
    the card tests hold it to)."""
    return 4 * _FWD_ROWS * (10 * fwd_width(F) + 16)


def tuned_width(F: int, bwd: bool) -> bool:
    """Whether the tuned instance takes width F: K3 up to the opt-in shared
    memory limit (F <= ``FWD_MAX_F``), K4 ``BWD_WIDTHS``; the general
    instances take every other F."""
    if bwd:
        return F % 32 == 0 and F <= 256
    return mix_fwd_smem_bytes(F) <= _build.MAX_DYN_SMEM


def check_width(F: int) -> None:
    """Raise ``ValueError`` for a width no instance takes: F < 1 (the
    tuned or the general instance takes every other, ``tuned_width``)."""
    if F < 1:
        raise ValueError(f"the mixing kernels need F >= 1, got F={F}")


def padded_weights(kmix, k0, b0, k1, b1):
    """``pad_weights`` of these weight tensors, made once per parameter
    version (``_build.cached_per_version``)."""
    return _build.cached_per_version(pad_weights, kmix, k0, b0, k1, b1)


def pad_weights(kmix, k0, b0, k1, b1):
    """The mixing weights at K3's width FP, each block of F rows or columns
    zero-padded to FP: kmix [FP, 2FP], k0 [2FP, FP], b0 [FP], k1 [FP,
    3FP], b1 [3FP].  K3's wrapper pads a copy per call at F % 32 != 0,
    which no PaiNN path takes (the message kernels take F % 32 == 0)."""
    F = kmix.shape[0]
    FP = fwd_width(F)

    def cols(t, blocks):
        """[..., blocks F] -> [..., blocks FP]"""
        out = t.new_zeros((*t.shape[:-1], blocks, FP))
        out[..., :F] = t.reshape(*t.shape[:-1], blocks, F)
        return out.flatten(-2)

    def rows(t, blocks):
        return cols(t.t(), blocks).t().contiguous()

    with torch.no_grad():
        return (rows(cols(kmix, 2), 1), rows(cols(k0, 1), 2), cols(b0, 1),
                rows(cols(k1, 3), 1), cols(b1, 3))


def bwd_weights(kmix, k0, b0, k1, b1):
    """K4's weights, made once per parameter version
    (``_build.cached_per_version``): (kmix, k0, b0, k1, b1) as they are at
    F % 32 == 0, else zero-padded (``padded_weights``), and the transposed
    copies (kmix^T, k0^T, k1^T) that give the kernel's transposed products
    the B fragment loads of the others."""
    return _build.cached_per_version(_bwd_weights, kmix, k0, b0, k1, b1)


def _bwd_weights(kmix, k0, b0, k1, b1):
    w = (kmix, k0, b0, k1, b1)
    if kmix.shape[0] % FWD_PAD:
        w = padded_weights(*w)
    with torch.no_grad():
        return (*w, *(t.t().contiguous() for t in (w[0], w[1], w[3])))


def painn_mixing_plain(q, mu, dq, dmu, kmix, k0, b0, k1, b1, eps: float,
                       act: str):
    """Plain twin of K3 (``painn_mixing.py:48-70``): (q_out, mu_out)."""
    F = q.shape[1]
    qp = q + dq
    mup = mu + dmu
    mu_c = mup.split(F, dim=1)
    V_c = [m @ kmix[:, :F] for m in mu_c]
    W_c = [m @ kmix[:, F:] for m in mu_c]
    Vn = torch.sqrt(V_c[0] ** 2 + V_c[1] ** 2 + V_c[2] ** 2 + eps)
    h = ACTIVATIONS[act](qp @ k0[:F] + Vn @ k0[F:] + b0)
    dq_i, dmu_i, dqmu_i = (h @ k1 + b1).split(F, dim=1)
    vw = V_c[0] * W_c[0] + V_c[1] * W_c[1] + V_c[2] * W_c[2]
    q_out = qp + dq_i + dqmu_i * vw
    mu_out = torch.cat([m + dmu_i * w for m, w in zip(mu_c, W_c)], dim=1)
    return q_out, mu_out


def painn_mixing_bwd_plain(q, mu, dq, dmu, kmix, k0, b0, k1, b1, eps, act,
                           gq, gmu, wgrad: bool = False):
    """Plain twin of K4: cotangents of (q + dq, mu + dmu), and with
    ``wgrad`` also of (kmix, k0, b0, k1, b1)."""
    with torch.enable_grad():
        qp = (q + dq).detach().requires_grad_(True)
        mup = (mu + dmu).detach().requires_grad_(True)
        w = [t.detach().requires_grad_(wgrad) for t in (kmix, k0, b0, k1, b1)]
        z = torch.zeros_like
        out = painn_mixing_plain(qp, mup, z(q), z(mu), *w, eps, act)
        return torch.autograd.grad(out, (qp, mup, *w) if wgrad else (qp, mup),
                                   (gq, gmu))


def _check(q, mu, dq, dmu, kmix, k0, b0, k1, b1, act):
    A, F = q.shape
    if act not in _ACT_CODE:
        raise ValueError(f"unknown activation {act!r}")
    check_width(F)
    for t, n, s in ((q, "q", (A, F)), (mu, "mu", (A, 3 * F)),
                    (dq, "dq", (A, F)), (dmu, "dmu", (A, 3 * F)),
                    (kmix, "kmix", (F, 2 * F)), (k0, "k0", (2 * F, F)),
                    (b0, "b0", (F,)), (k1, "k1", (F, 3 * F)),
                    (b1, "b1", (3 * F,))):
        _build.check(t, n, s)
    if A == 0:
        raise ValueError("painn mixing kernels need at least one row")


def mix_fwd_kernel(q, mu, dq, dmu, kmix, k0, b0, k1, b1, eps: float,
                   act: str):
    """K3: (q_out [A, F], mu_out [A, 3F])."""
    _check(q, mu, dq, dmu, kmix, k0, b0, k1, b1, act)
    A, F = q.shape
    qo = torch.empty_like(q)
    muo = torch.empty_like(mu)
    p = _build.ptr
    if not tuned_width(F, bwd=False):
        ws = q.new_empty((A, _build.query("spk_mix_gen_ws", F)))
        _build.launch("spk_mix_fwd_gen", p(q), p(mu), p(dq), p(dmu),
                      p(kmix), p(k0), p(b0), p(k1), p(b1), p(qo), p(muo),
                      p(ws), A, F, float(eps), _ACT_CODE[act])
        LAUNCHES["mix_fwd_gen"] += 1
        return qo, muo
    if F % FWD_PAD:
        kmix, k0, b0, k1, b1 = padded_weights(kmix, k0, b0, k1, b1)
    _build.launch("spk_mix_fwd", p(q), p(mu), p(dq), p(dmu), p(kmix), p(k0),
                  p(b0), p(k1), p(b1), p(qo), p(muo), A, F, float(eps),
                  _ACT_CODE[act])
    LAUNCHES["mix_fwd"] += 1
    return qo, muo


def mix_bwd_kernel(q, mu, dq, dmu, kmix, k0, b0, k1, b1, eps: float,
                   act: str, gq, gmu, wgrad: bool = False):
    """K4: cotangents (g_qp [A, F], g_mup [A, 3F]) of K3's inputs, and with
    ``wgrad`` also (gkmix, gk0, gb0, gk1, gb1): the f64 partials of the
    kernel's row ranges summed here and rounded to f32."""
    _check(q, mu, dq, dmu, kmix, k0, b0, k1, b1, act)
    A, F = q.shape
    gen = not tuned_width(F, bwd=True)
    _build.check(gq, "gq", (A, F))
    _build.check(gmu, "gmu", (A, 3 * F))
    weights = bwd_weights(kmix, k0, b0, k1, b1)
    gqi = torch.empty_like(q)
    gmui = torch.empty_like(mu)
    S = part = None
    nsplit = 0
    if wgrad:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        nsplit = wgrad_splits(A, F, sms)
        S = q.new_empty((A, 16 * F))
        part = q.new_empty((nsplit, 7 * F * F + 4 * F), dtype=torch.float64)
    p = _build.ptr
    _build.launch("spk_mix_bwd_gen" if gen else "spk_mix_bwd", p(q), p(mu),
                  p(dq), p(dmu), p(gq), p(gmu), *map(p, weights), p(gqi),
                  p(gmui), None if S is None else p(S),
                  None if part is None else p(part), nsplit, A, F,
                  float(eps), _ACT_CODE[act])
    name = ("mix_bwd_wgrad" if wgrad else "mix_bwd") + ("_gen" if gen else "")
    LAUNCHES[name] += 1
    if not wgrad:
        return gqi, gmui
    w = part.sum(0).to(torch.float32)
    FF = F * F
    return (gqi, gmui, w[:2 * FF].view(F, 2 * F),
            w[2 * FF:4 * FF].view(2 * F, F), w[4 * FF:4 * FF + F],
            w[4 * FF + F:7 * FF + F].view(F, 3 * F), w[7 * FF + F:])


class PaiNNMixingFused(torch.autograd.Function):
    """K3 forward, K4 backward (its wgrad instance when a weight needs a
    gradient)."""

    @staticmethod
    def forward(ctx, q, mu, dq, dmu, kmix, k0, b0, k1, b1, eps, act):
        ctx.save_for_backward(q, mu, dq, dmu, kmix, k0, b0, k1, b1)
        ctx.eps, ctx.act = eps, act
        return mix_fwd_kernel(q, mu, dq, dmu, kmix, k0, b0, k1, b1, eps, act)

    @staticmethod
    def backward(ctx, gq, gmu):
        need_w = ctx.needs_input_grad[4:9]
        gqi, gmui, *gw = mix_bwd_kernel(
            *ctx.saved_tensors, ctx.eps, ctx.act, gq.contiguous(),
            gmu.contiguous(), wgrad=any(need_w))
        gw = [g if n else None for g, n in zip(gw, need_w)] or [None] * 5
        return (gqi, gmui, gqi, gmui, *gw, None, None)


def painn_mixing_fused(q, mu, dq, dmu, kmix, k0, b0, k1, b1, eps: float,
                       act: str):
    """Residual add + PaiNN mixing block (signature of
    ``schnetpack_tpu.ops.painn_mixing.painn_mixing_fused``)."""
    if not q.is_cuda:
        return painn_mixing_plain(q, mu, dq, dmu, kmix, k0, b0, k1, b1, eps,
                                  act)
    return PaiNNMixingFused.apply(q, mu, dq, dmu, kmix, k0, b0, k1, b1,
                                  float(eps), act)
