"""JAX's counter-based random numbers in torch: threefry2x32 keys and
normal draws, bit for bit as ``jax.random`` makes them (JAX 0.9,
``jax_threefry_partitionable=True``, the default there), so the slab
path's Langevin chunk draws the noise of the JAX package's
``make_sharded_column_chunk``.

A key is an int64 tensor [..., 2] holding two uint32 words; every op is
plain integer arithmetic masked to 32 bits, so the same draws come out on
the CPU and on ``cuda``, and every function broadcasts over leading key
axes (one key per step and column in one call).

* ``prng_key(seed)`` is ``jax.random.PRNGKey`` (``prng.py:802
  threefry_seed``); ``split(key, n)`` is ``jax.random.split``
  (``_threefry_split_foldlike``: the hash of the counts (0, i));
  ``fold_in(key, data)`` is ``jax.random.fold_in`` (the hash of (0,
  data)).
* ``normal(key, n)`` is ``jax.random.normal(key, (n,), float32)``: 32
  random bits per value (the two hash words of the counts (0, i) XORed),
  their 23 high bits as a float in [1, 2), mapped onto [nextafter(-1, 0),
  1), then sqrt(2) erfinv.  ``erfinv`` is XLA's float32 approximation
  (Giles' polynomials in -log1p(-x^2), ``chlo`` ``erf_inv``), its Horner
  steps each rounded once as a fused multiply-add rounds; torch's own
  ``erfinv`` differs from JAX's by up to 90 ulps in the tails.  What is
  left is the ulps of ``log1p``: at most 3 ulps of the normal value
  (under 5e-7) on 3e5 draws against JAX on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
#: threefry2x32's rotations of its two round groups, and its key parity
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: the lower end of ``jax.random.normal``'s uniform draw
_LO = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
_SPAN = np.float32(1.0) - _LO
_SQRT2 = np.float32(np.sqrt(2.0))
#: XLA's float32 erfinv: Horner coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the count words (x1, x2) under the key
    words (k1, k2) (``prng.py:883 _threefry2x32_lowering``); int64
    tensors holding uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with JAX's default 32-bit types: the
    words (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: [..., num, 2]."""
    cnt = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(cnt),
                        cnt)
    return torch.stack([a, b], -1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for every element of ``data``
    (broadcast against the key's leading axes): [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                        data)
    return torch.stack([a, b], -1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per value: [..., n] (``prng.py:1184``)."""
    cnt = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(cnt),
                        cnt)
    return a ^ b


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, nextafter(-1, 0), 1)``."""
    bits = random_bits(key, n)
    one_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    f = (one_two - 1.0) * float(_SPAN) + float(_LO)
    return torch.clamp(f, min=float(_LO))


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv (see the module's docstring)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coeff(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device))

    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        # one rounding a step, as a fused multiply-add: the product of
        # two floats is exact in double
        p = (coeff(i).double() + p.double() * w).float()
    big = float(np.finfo(np.float32).max)
    return torch.where(x.abs() == 1.0, x * big, p * x)


def normal(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.normal(key, (n,), float32)``: [..., n]."""
    return float(_SQRT2) * erfinv_f32(uniform(key, n))
