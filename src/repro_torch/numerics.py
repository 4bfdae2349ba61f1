"""Float32 arithmetic that reproduces the JAX reference bit for bit.

The reference runs under XLA on the CPU, and three of its habits decide
the last bit of some f32 results.  The port's plain tensor code and its
CUDA kernels both follow them, so that every discrete decision (an ECN
mark, a window comparison, a warp target) comes out the same:

* **Division by a constant is a multiply by its f32 reciprocal.**  XLA's
  algebraic simplifier rewrites ``x / c`` as ``x * (1.0f / c)``
  (:func:`recip32`).  Division by a tensor stays an IEEE division.
* **Multiply-add pairs in one fused loop become an FMA.**  XLA's CPU
  backend lets LLVM contract ``a * b + c`` into a fused multiply-add when
  both sit in one fused loop body (a product computed outside the fusion,
  or hoisted out of the loop as ``t * tick_us`` for the scalar tick is,
  is not contracted).  On the main path this hits the CC delay EWMA
  (:func:`fma32` computes a correctly rounded FMA on any device) and the
  scalar timer deadlines ``now + c`` (:func:`now_plus`); the ECN dither's
  sum is not contracted (the fabric program precomputes its row product).
* **``sin`` is glibc's ``sinf``.**  XLA's CPU backend calls the C
  library's ``sinf``; ``torch.sin`` (SLEEF on the CPU, CUDA's ``sinf`` on
  the card) differs from it by one ulp at some arguments.
  :func:`sinf` is glibc's algorithm (double-precision reduction and
  polynomial) written in float64 tensor ops; the CUDA kernels carry the
  same code in C.

Python constants used in f32 tensor ops are rounded with :func:`f32` on
the host first, in the reference's grouping.
"""
from __future__ import annotations

import numpy as np
import torch


def f32(x: float) -> float:
    """``x`` rounded once to float32, as a Python float."""
    return float(np.float32(x))


def recip32(c: float) -> float:
    """``1.0f / float32(c)``: the multiplier XLA substitutes for ``/ c``."""
    return float(np.float32(1.0) / np.float32(c))


class Now(float):
    """The fabric's ``now = t.astype(f32) * tick_us`` for tick ``t``.

    It is a float (the rounded product) that remembers ``t`` and the tick
    length, because the reference contracts the scalar-only sums
    ``now + c`` (timer deadlines) into one FMA: see :func:`now_plus`."""

    def __new__(cls, t: int, tick_us: float):
        obj = float.__new__(cls, float(np.float32(t) * np.float32(tick_us)))
        obj.t, obj.tick_us = int(t), float(tick_us)
        return obj


def now_plus(now: float, c: float) -> float:
    """``now + c`` in float32 as the reference computes it: one FMA
    ``fmaf(t, tick_us, c)`` when ``now`` is a fabric tick's :class:`Now`
    (exact here: the float32 product and the sum fit in a double), else a
    plain float32 add."""
    if isinstance(now, Now):
        return float(np.float32(np.float64(np.float32(now.t))
                                * np.float64(np.float32(now.tick_us))
                                + np.float64(np.float32(c))))
    return f32(np.float32(now) + np.float32(c))


def fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (one rounding, like
    ``fmaf``).  The product of two floats is exact in float64; the sum is
    taken with round-to-odd (TwoSum error term plus a one-ulp nudge), so
    the final rounding to float32 is the single correct one."""
    a64 = a.double()
    b64 = b.double() if isinstance(b, torch.Tensor) else float(np.float32(b))
    c64 = c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    odd = (s.view(torch.int64) & 1) == 1
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & (~odd), torch.nextafter(s, toward), s)
    return s.float()


# --------------------------------------------------------------------------- #
# glibc sinf (sysdeps/ieee754/flt-32/s_sinf.c, the ARM optimized-routines
# algorithm): double-precision range reduction, then a degree-7 sine or
# degree-8 cosine polynomial, rounded once to float.
# --------------------------------------------------------------------------- #

_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")   # 2/pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")          # pi/2
_PI63 = float.fromhex("0x1.921FB54442D18p-62")       # 2pi * 2^-64
_C0, _C1, _C2, _C3, _C4 = (1.0,
                           float.fromhex("-0x1.ffffffd0c621cp-2"),
                           float.fromhex("0x1.55553e1068f19p-5"),
                           float.fromhex("-0x1.6c087e89a359dp-10"),
                           float.fromhex("0x1.99343027bf8c3p-16"))
_S1, _S2, _S3 = (float.fromhex("-0x1.555545995a603p-3"),
                 float.fromhex("0x1.1107605230bc4p-7"),
                 float.fromhex("-0x1.994eb3774cf24p-13"))
#: 4/pi to 192 bits; each entry adds 8 new bits (glibc __inv_pio4).
INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e,
            0xf9836e4e, 0x836e4e44, 0x6e4e4415, 0x4e441529,
            0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
            0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
            0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599,
            0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041)
_TOP_TINY = 0x398    # abstop12(0x1p-12f)
_TOP_PIO4 = 0x3F4    # abstop12(0x1.921FB6p-1f)
_TOP_120 = 0x42F     # abstop12(120.0f)
_M32 = 0xFFFFFFFF


def _sinf_poly(x, x2, n):
    """glibc ``sinf_poly``: sine polynomial for even quadrants, cosine for
    odd ones (the cosine sign of quadrants 2-3 rides in ``x``'s sign
    flip and the table's negated coefficients, handled by the caller)."""
    x3 = x * x2
    s1 = _S2 + x2 * _S3
    x7 = x3 * x2
    s = x + x3 * _S1
    sin_v = s + x7 * s1
    x4 = x2 * x2
    c2 = _C3 + x2 * _C4
    c1 = _C0 + x2 * _C1
    x6 = x4 * x2
    c = c1 + x4 * _C2
    cos_v = c + x6 * c2
    return torch.where((n & 1) == 0, sin_v, cos_v)


def sinf(y: torch.Tensor) -> torch.Tensor:
    """glibc-exact float32 ``sin`` of a float32 tensor (finite inputs)."""
    if y.dtype != torch.float32:
        raise TypeError(f"sinf takes float32, got {y.dtype}")
    xi = y.view(torch.int32).to(torch.int64) & _M32
    top = (xi >> 20) & 0x7FF
    sign = (xi >> 31) & 1
    x = y.double()

    # |y| < 120: one multiply-subtract reduction
    r = x * _HPI_INV
    n_f = ((r.to(torch.int32) + 0x800000) >> 24).to(torch.int64)
    x_f = x - n_f.double() * _HPI

    # |y| >= 120: 4/pi table reduction in 64-bit integer arithmetic
    tbl = torch.tensor(INV_PIO4, dtype=torch.int64, device=y.device)
    base = (xi >> 26) & 15
    shift = (xi >> 23) & 7
    m = ((xi & 0xFFFFFF) | 0x800000) << shift
    res0 = (m * tbl[base]) & _M32
    res1 = m * tbl[base + 4]
    res2 = m * tbl[base + 8]
    res0 = ((res2 >> 32) & _M32) | (res0 << 32)
    res0 = res0 + res1
    n_l = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n_l << 62)
    x_l = res0.double() * _PI63
    n_l = n_l + sign

    small = top < _TOP_PIO4
    fast = top < _TOP_120
    n = torch.where(small, torch.zeros_like(n_f),
                    torch.where(fast, n_f, n_l))
    xr = torch.where(small, x, torch.where(fast, x_f, x_l))
    # quadrant sign of sine / cosine; quadrants 2-3 also negate cosine
    q = torch.where(fast, n, n_l) & 3
    sgn = torch.where((q == 1) | (q == 2), -1.0, 1.0).to(torch.float64)
    xs = torch.where(small, xr, xr * sgn)
    poly_n = torch.where(small | fast, n, n_l - sign)
    v = _sinf_poly(xs, xr * xr, poly_n)
    cos_neg = (~small) & ((q & 2) != 0) & ((poly_n & 1) == 1)
    v = torch.where(cos_neg, -v, v)
    out = v.float()
    return torch.where(top < _TOP_TINY, y, out)


def ecn_dither(t, rows: torch.Tensor) -> torch.Tensor:
    """``|sin(t * 12.9898 + row * 78.233)|`` in float32, as the reference's
    serve stage computes it for tick ``t`` (an int, or an int tensor that
    broadcasts against ``rows``).  Both products round on their own: in
    the reference's fabric program the row product is precomputed outside
    the fused loop, so nothing contracts here."""
    tf = torch.as_tensor(t, dtype=torch.int32, device=rows.device
                         ).to(torch.float32) * f32(12.9898)
    return sinf(tf + rows.to(torch.float32) * f32(78.233)).abs()
