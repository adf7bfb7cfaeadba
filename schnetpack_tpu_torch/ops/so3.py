"""SO(3) machinery: real spherical harmonics and Clebsch-Gordan coupling.

Port of ``schnetpack_tpu/ops/so3.py``.  Same conventions: real spherical
harmonics in the reference's normalisation, flattened index
``lm = l^2 + l + m``, and the dense real-basis CG tensor [n_lm, n_lm,
n_lm].  The JAX package evaluates the complex CG coefficients with sympy;
here they come from Racah's closed formula in exact integer factorials
(``math.factorial``), followed by the same complex-to-real change of basis,
the same choice of the real or imaginary part of each block and the same
parity rule, so the port needs no sympy.
"""
from __future__ import annotations

import functools
from math import factorial, pi, sqrt

import numpy as np
import torch


def real_spherical_harmonics(directions: torch.Tensor,
                             lmax: int) -> torch.Tensor:
    """Y_lm of unit vectors: [..., 3] -> [..., (lmax+1)^2], by the JAX
    package's recurrences (sectoral cos/sin multiples and the associated
    Legendre recurrence with sin^m absorbed)."""
    x, y, z = directions.unbind(-1)
    c = [torch.ones_like(x)]
    s = [torch.zeros_like(x)]
    for m in range(1, lmax + 1):
        c.append(x * c[m - 1] - y * s[m - 1])
        s.append(x * s[m - 1] + y * c[m - 1])

    pbar = [[None] * (lmax + 1) for _ in range(lmax + 1)]
    for m in range(lmax + 1):
        dfac = 1.0
        for k in range(1, 2 * m, 2):
            dfac *= k
        pbar[m][m] = torch.full_like(z, dfac)
        if m + 1 <= lmax:
            pbar[m + 1][m] = (2 * m + 1) * z * pbar[m][m]
        for l in range(m + 2, lmax + 1):
            pbar[l][m] = ((2 * l - 1) * z * pbar[l - 1][m]
                          - (l + m - 1) * pbar[l - 2][m]) / (l - m)

    out = []
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            K = sqrt((2 * l + 1) / (4.0 * pi) * factorial(l - am)
                     / factorial(l + am))
            if m == 0:
                out.append(K * pbar[l][0])
            elif m > 0:
                out.append(sqrt(2.0) * K * pbar[l][am] * c[am])
            else:
                out.append(sqrt(2.0) * K * pbar[l][am] * s[am])
    return torch.stack(out, dim=-1)


def clebsch_gordan(l1: int, m1: int, l2: int, m2: int, l3: int,
                   m3: int) -> float:
    """Complex CG coefficient <l1 m1 l2 m2 | l3 m3> (Condon-Shortley
    phase, as sympy's ``CG``), from Racah's formula."""
    if m3 != m1 + m2 or not abs(l1 - l2) <= l3 <= l1 + l2:
        return 0.0
    if abs(m1) > l1 or abs(m2) > l2 or abs(m3) > l3:
        return 0.0
    f = factorial
    pre = ((2 * l3 + 1) * f(l3 + l1 - l2) * f(l3 - l1 + l2)
           * f(l1 + l2 - l3) / f(l1 + l2 + l3 + 1))
    pre *= (f(l3 + m3) * f(l3 - m3) * f(l1 - m1) * f(l1 + m1) * f(l2 - m2)
            * f(l2 + m2))
    total = 0.0
    for k in range(0, l1 + l2 - l3 + 1):
        args = (k, l1 + l2 - l3 - k, l1 - m1 - k, l2 + m2 - k,
                l3 - l2 + m1 + k, l3 - l1 - m2 + k)
        if min(args) < 0:
            continue
        den = 1
        for a in args:
            den *= f(a)
        total += (-1) ** k / den
    return sqrt(pre) * total


def _u_matrix(l: int) -> np.ndarray:
    """Complex -> real change of basis of degree l (rows: real m)."""
    dim = 2 * l + 1
    U = np.zeros((dim, dim), complex)
    for m in range(-l, l + 1):
        i = m + l
        if m < 0:
            U[i, m + l] = 1j / np.sqrt(2)
            U[i, -m + l] = -1j * (-1) ** m / np.sqrt(2)
        elif m == 0:
            U[i, l] = 1.0
        else:
            U[i, -m + l] = 1 / np.sqrt(2)
            U[i, m + l] = (-1) ** m / np.sqrt(2)
    return U


@functools.lru_cache(maxsize=8)
def cg_dense_np(lmax: int, parity_invariance: bool = True) -> np.ndarray:
    """Dense real-basis CG tensor [n_lm, n_lm, n_lm] (``_cg_dense_np``):
    couplings with odd l1+l2+l3 are zero under ``parity_invariance``."""
    n = (lmax + 1) ** 2
    cg = np.zeros((n, n, n))
    for l1 in range(lmax + 1):
        for l2 in range(lmax + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, lmax) + 1):
                blk = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
                for m1 in range(-l1, l1 + 1):
                    for m2 in range(-l2, l2 + 1):
                        m3 = m1 + m2
                        if abs(m3) <= l3:
                            blk[m1 + l1, m2 + l2, m3 + l3] = clebsch_gordan(
                                l1, m1, l2, m2, l3, m3)
                cplx = np.einsum("ai,bj,ck,ijk->abc", _u_matrix(l1),
                                 _u_matrix(l2), np.conj(_u_matrix(l3)), blk)
                # the real-basis block is purely real (even l1+l2+l3) or
                # purely imaginary (odd); take the part that is not zero
                if np.abs(cplx.imag).max() > np.abs(cplx.real).max():
                    real_blk = cplx.imag
                else:
                    real_blk = cplx.real
                if parity_invariance and (l1 + l2 + l3) % 2 == 1:
                    continue
                o1, o2, o3 = l1 * l1, l2 * l2, l3 * l3
                cg[o1:o1 + 2 * l1 + 1, o2:o2 + 2 * l2 + 1,
                   o3:o3 + 2 * l3 + 1] += real_blk
    return cg


def cg_dense(lmax: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(cg_dense_np(lmax), dtype=dtype, device=device)


def degree_index(lmax: int) -> np.ndarray:
    """[(lmax+1)^2] array mapping lm -> l (for per-degree weights)."""
    return np.concatenate([np.full(2 * l + 1, l, np.int64)
                           for l in range(lmax + 1)])


def cg_by_degree(lmax: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The CG tensor split by the degree of its first slot, laid out for
    the convolution's message: [n_lm, n_lm * (lmax+1) * n_lm] with entry
    (p, (r, l, q)) = cg[p, q, r] when p has degree l, else 0.  Per edge,
    ``Y @ cg_by_degree`` gives the [n_lm, (lmax+1) * n_lm] matrix
    M[r, (l, q)] = sum over p of degree l of cg[p, q, r] Y_p."""
    cg = cg_dense_np(lmax)
    deg = degree_index(lmax)
    n = cg.shape[0]
    out = np.zeros((n, n, lmax + 1, n))
    out[np.arange(n), :, deg, :] = cg.transpose(0, 2, 1)
    return torch.as_tensor(out.reshape(n, -1), dtype=dtype, device=device)


def scalar2rsh(x: torch.Tensor, lmax: int) -> torch.Tensor:
    """Pad scalar features [A, F] (or [A, 1, F]) to [A, (lmax+1)^2, F] with
    zeros in the l > 0 channels."""
    if x.ndim == 2:
        x = x[:, None, :]
    pad = (lmax + 1) ** 2 - x.shape[1]
    return torch.nn.functional.pad(x, (0, 0, 0, pad))


def so3_tensor_product(x1: torch.Tensor, x2: torch.Tensor,
                       cg: torch.Tensor) -> torch.Tensor:
    """CG contraction of two [..., n_lm, F] fields, elementwise over the
    leading axes and F: out[..., r, f] = sum_pq cg[p, q, r] x1[..., p, f]
    x2[..., q, f]."""
    n = cg.shape[0]
    # t[..., q, r, f] = sum_p cg[p, q, r] x1[..., p, f]
    t = torch.matmul(cg.reshape(n, n * n).t(), x1)
    t = t.reshape(x1.shape[:-2] + (n, n, x1.shape[-1]))
    return (t * x2.unsqueeze(-2)).sum(-3)
