"""Double-double (compensated) arithmetic: the beyond-f64 precision tier.

Device replacement for the reference's vendored MPFUN-MPFR stack
(mpfun-mpfr-v08/: mp_real with 120 decimal digits via GNU MPFR C shims,
mpfunf.f90:63, mpinterface.c) and the hand-rolled OpenMP mp BLAS
(mpblas.f90).  Arbitrary-precision software arithmetic does not vectorize;
double-double arithmetic (~32 significant digits) covers the reference's
practical use — high-precision quadrature accumulation and TT contraction
(mptt_quad) — with every operation built from error-free transforms
(two_sum / two_prod with Dekker splitting) that vectorize in pure f64.

A DD value is a pair (hi, lo) with |lo| <= ulp(hi)/2; arrays of DD values
are pairs of equal-shape f64 arrays (struct-of-arrays).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["DD", "dd", "two_sum", "two_prod", "dd_add", "dd_sub", "dd_mul",
           "dd_div", "dd_neg", "dd_abs", "dd_sum", "dd_dot", "dd_matvec",
           "dd_matmul", "dd_to_float", "dd_from_string", "dd_to_string",
           "dd_contract", "dd_gather_tt", "dd_exp", "dd_log"]

_SPLIT = 134217729.0  # 2^27 + 1, Dekker splitting constant for binary64


class DD(NamedTuple):
    hi: jax.Array
    lo: jax.Array

    @property
    def shape(self):
        return jnp.shape(self.hi)


def dd(hi, lo=0.0) -> DD:
    hi = jnp.asarray(hi, jnp.float64)
    return DD(hi, jnp.broadcast_to(jnp.asarray(lo, jnp.float64), hi.shape))


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly (Knuth)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    t = _SPLIT * a
    ahi = t - (t - a)
    return ahi, a - ahi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker splitting; no FMA
    dependency, IEEE-correct f64 suffices)."""
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def dd_add(x: DD, y: DD) -> DD:
    s, e = two_sum(x.hi, y.hi)
    e = e + x.lo + y.lo
    s, e = _quick_two_sum(s, e)
    return DD(s, e)


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_sub(x: DD, y: DD) -> DD:
    return dd_add(x, dd_neg(y))


def dd_abs(x: DD) -> DD:
    neg = x.hi < 0
    return DD(jnp.where(neg, -x.hi, x.hi), jnp.where(neg, -x.lo, x.lo))


def dd_mul(x: DD, y: DD) -> DD:
    p, e = two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    p, e = _quick_two_sum(p, e)
    return DD(p, e)


def dd_div(x: DD, y: DD) -> DD:
    q1 = x.hi / y.hi
    r = dd_sub(x, dd_mul(dd(q1), y))
    q2 = r.hi / y.hi
    r = dd_sub(r, dd_mul(dd(q2), y))
    q3 = r.hi / y.hi
    s, e = _quick_two_sum(q1, q2)
    s, e2 = _quick_two_sum(s, e + q3)
    return DD(s, e2)


def dd_sum(x: DD, axis=None) -> DD:
    """Reduction by pairwise compensated accumulation over a flattened axis
    (replaces mpblas sum loops; sequential scan keeps full dd accuracy)."""
    hi = jnp.moveaxis(x.hi, axis, 0) if axis is not None else x.hi.reshape(-1)
    lo = jnp.moveaxis(x.lo, axis, 0) if axis is not None else x.lo.reshape(-1)

    def body(carry, t):
        return dd_add(carry, DD(t[0], t[1])), None

    init = dd(jnp.zeros(hi.shape[1:]))
    out, _ = jax.lax.scan(body, init, jnp.stack([hi, lo], axis=1))
    return out


def dd_dot(xh, xl, yh, yl) -> DD:
    """Compensated dot product of dd vectors (mpdot, mpblas.f90)."""
    prods = dd_mul(DD(xh, xl), DD(yh, yl))
    return dd_sum(prods)


def dd_matvec(Ah, Al, xh, xl) -> DD:
    """(m, n) dd matrix times dd vector (mpgemv, mpblas.f90)."""
    prods = dd_mul(DD(Ah, Al), DD(xh[None, :], xl[None, :]))
    return dd_sum(prods, axis=1)


def dd_matmul(Ah, Al, Bh, Bl) -> DD:
    """Small dd GEMM by contraction over the shared axis (mpgemm,
    mpblas.f90); shapes (m, k) x (k, n)."""
    prods = dd_mul(DD(Ah[:, :, None], Al[:, :, None]), DD(Bh[None], Bl[None]))
    return dd_sum(prods, axis=1)


def _dd_const(s: str) -> tuple[float, float]:
    from decimal import Decimal, localcontext

    with localcontext() as ctx:
        ctx.prec = 60
        v = Decimal(s)
        hi = float(v)
        return hi, float(v - Decimal(hi))


_LN2_HI, _LN2_LO = _dd_const(
    "0.69314718055994530941723212145817656807550013436025525412068")
# 1/k! as exact dd pairs, k = 2..16 (Taylor tail of exp on |r| <= ln2/1024)
import math as _math  # noqa: E402
from decimal import Decimal as _Dec, localcontext as _lc  # noqa: E402

_INV_FACT = []
with _lc() as _ctx:
    _ctx.prec = 60
    for _k in range(2, 17):
        _v = _Dec(1) / _Dec(_math.factorial(_k))
        _h = float(_v)
        _INV_FACT.append((_h, float(_v - _Dec(_h))))


def dd_exp(x: DD) -> DD:
    """Device dd exponential: range reduction x = k ln2 + r, scale r by
    2^-9, Taylor series to dd accuracy, 9 repeated squarings, ldexp by k
    (the qd-library scheme; the device-side mirror of MPFUN's mp exp,
    enabling dd integrands like exp(-sum x^2) to run on device instead of
    the rational-only path).  Elementwise over any shape."""
    k = jnp.round(x.hi / _LN2_HI)
    ln2 = DD(jnp.full_like(x.hi, _LN2_HI), jnp.full_like(x.hi, _LN2_LO))
    r = dd_sub(x, dd_mul(dd(k), ln2))
    r = DD(r.hi * (1.0 / 512.0), r.lo * (1.0 / 512.0))   # exact: power of 2
    # Horner over 1/k! tail, then + r + 1
    ph = jnp.full_like(x.hi, _INV_FACT[-1][0])
    pl = jnp.full_like(x.hi, _INV_FACT[-1][1])
    p = DD(ph, pl)
    for ch, cl in reversed(_INV_FACT[:-1]):
        p = dd_add(dd_mul(p, r), DD(jnp.full_like(x.hi, ch),
                                    jnp.full_like(x.hi, cl)))
    p = dd_mul(dd_mul(p, r), r)          # sum_{k>=2} r^k/k!
    p = dd_add(p, r)
    s = dd_add(p, dd(jnp.ones_like(x.hi)))
    for _ in range(9):
        s = dd_mul(s, s)
    pow2 = _exact_pow2(k)
    out = DD(s.hi * pow2, s.lo * pow2)
    # saturate outside binary64's range (the reference handles the same
    # regime by rescaling, test_crs_ising.f90:135-144): flush to zero below
    # the floor, overflow to inf above the ceiling (a clipped 2^k would
    # return a silently wrong FINITE value)
    floor, ceil = -708.0, 709.9
    z = jnp.zeros_like(x.hi)
    hi = jnp.where(x.hi < floor, z, jnp.where(x.hi > ceil, jnp.inf, out.hi))
    lo = jnp.where((x.hi < floor) | (x.hi > ceil), z, out.lo)
    return DD(hi, lo)


def pow2_balance(x):
    """Norm-balance by an EXACT power of two: returns (x * 2^-e, e) with
    max|x * 2^-e| near 1.  Shared by the value-chain balancing
    (cross/engine.py, parallel/engine.py) and the lookup range rescale
    (ops/dense.py); the approximate log2 only needs to land within a few
    exponents of the true one."""
    m = jnp.max(jnp.abs(x))
    e = jnp.floor(jnp.log2(jnp.where((m > 0) & jnp.isfinite(m), m, 1.0)))
    e = jnp.where(jnp.isfinite(e), e, 0.0)
    return x * _exact_pow2(-e), e


def _pow2_chain(k, bits: int):
    """2^k by a bit-wise squaring chain for integer |k| < 2^bits; every
    multiply is a power-of-two product (exponent add, no rounding).  The
    intermediate base reaches 2^(2^(bits-1)), so bits <= 10 stays finite
    in binary64."""
    kk = jnp.abs(k).astype(jnp.int32)
    result = jnp.ones_like(k)
    base = jnp.full_like(k, 2.0)
    for i in range(bits):
        result = jnp.where((kk >> i) & 1 == 1, result * base, result)
        if i < bits - 1:
            base = base * base
    return jnp.where(k < 0, 1.0 / result, result)


def _exact_pow2(k):
    """Exact 2^k for integer-valued f64 k.  jnp.exp2 may lower as
    exp(k ln2), which is not exact, so the power is built from exact
    squarings.

    k is split into two halves (|half| <= 530, each chain finite) so every
    k in [-1060, 1060] is exact and k > 1023 overflows to inf as true 2^k
    would.  Beyond the clamp range the result SATURATES to inf / 0.0 (a
    clamped-k chain value would be a silently wrong finite scale; the
    subnormal tail below the negative clamp is flushed to 0, like dd_exp's
    floor/ceil saturation)."""
    kc = jnp.clip(k, -1060.0, 1060.0)
    a = jnp.trunc(kc * 0.5)
    r = _pow2_chain(a, 10) * _pow2_chain(kc - a, 10)
    return jnp.where(k < -1060.0, 0.0, jnp.where(k > 1060.0, jnp.inf, r))


def dd_log(x: DD) -> DD:
    """Device dd logarithm by Newton iteration on dd_exp: y_{n+1} = y_n +
    x exp(-y_n) - 1, seeded with the f64 log."""
    y = dd(jnp.log(x.hi))
    for _ in range(2):
        e = dd_exp(dd_neg(y))
        y = dd_add(y, dd_sub(dd_mul(x, e), dd(jnp.ones_like(x.hi))))
    return y


def dd_to_float(x: DD):
    return x.hi + x.lo


def dd_from_string(s: str) -> tuple[float, float]:
    """Parse a decimal string into (hi, lo) on host — for the ~500-digit
    truth constants (apps/truths.py)."""
    from decimal import Decimal, localcontext

    with localcontext() as ctx:
        ctx.prec = 80
        v = Decimal(s)
        hi = float(v)
        lo = float(v - Decimal(hi))
    return hi, lo


def dd_to_string(x, digits: int = 32) -> str:
    """Render a (scalar) DD to `digits` decimal digits (mpsay analogue,
    mpfung1.f90:526)."""
    from decimal import Decimal, localcontext

    with localcontext() as ctx:
        ctx.prec = digits + 10
        v = Decimal(float(np.asarray(x.hi))) + Decimal(float(np.asarray(x.lo)))
        return f"{v:.{digits}e}"


def dd_gather_tt(t, ind) -> DD:
    """Evaluate an f64 TT at (B, d) indices with all accumulation in dd:
    the chain of matvecs runs through dd_mul/dd_sum so the result carries
    ~32 significant digits of the exact product of the stored f64 cores.
    Jittable; used by the defect-correction pipeline (cross/defect.py)."""
    import jax.numpy as jnp

    ind = jnp.asarray(ind)
    B = ind.shape[0]
    v = DD(jnp.ones((B, 1)), jnp.zeros((B, 1)))
    for c in range(t.d):
        g = jnp.take(t.cores[c], ind[:, c], axis=1)          # (r, B, r2)
        g = jnp.moveaxis(g, 1, 0)                            # (B, r, r2)
        prod = dd_mul(DD(v.hi[:, :, None], v.lo[:, :, None]),
                      DD(g, jnp.zeros_like(g)))              # (B, r, r2)
        v = dd_sum(prod, axis=1)                             # (B, r2)
    return DD(v.hi[:, 0], v.lo[:, 0])


def dd_contract(t, weights_hi, weights_lo=None) -> DD:
    """TT contraction against per-mode weights carried in dd: the
    high-precision quadrature path (mptt_quad, dmrggmp.f90:778-888).  The TT
    cores are f64 (exact when promoted to dd); all accumulation is dd."""
    d = t.d
    if weights_lo is None:
        weights_lo = [np.zeros_like(np.asarray(w)) for w in weights_hi]
    R = max(t.r)
    vh = jnp.zeros((1,), jnp.float64).at[0].set(1.0)
    vl = jnp.zeros((1,), jnp.float64)
    for c in range(d):
        g = t.cores[c]                       # (r, n, r')
        wh = jnp.asarray(weights_hi[c])
        wl = jnp.asarray(weights_lo[c])
        # m[i, j] = sum_n g[i, n, j] * w[n]  in dd
        prods = dd_mul(DD(g, jnp.zeros_like(g)),
                       DD(wh[None, :, None], wl[None, :, None]))
        m = dd_sum(prods, axis=1)            # DD (r, r')
        # v' = v @ m in dd
        prods = dd_mul(DD(vh[:, None], vl[:, None]), m)
        v = dd_sum(prods, axis=0)
        vh, vl = v.hi, v.lo
    return DD(vh[0], vl[0])
