"""Quad-double (4-limb compensated) arithmetic: the ~62-digit tier.

Extends the double-double layer (ops/dd.py) to four f64 limbs, covering
the gap between dd (~32 digits) and the host mpmath engine (120 digits,
cross/engine_mp.py) in the reference's multiprecision role (mptt_dmrgg /
mptt_quad, dmrggmp.f90; the vendored MPFUN-MPFR stack).  The payoff is
the defect-correction pipeline (cross/defect.py): with a qd integrand a
THREE-level defect cross bottoms out near 1e-45 |A| instead of dd's
1e-31, while every cross still runs in the fast f64 device engine.

A QD value is four f64 limbs (e0, e1, e2, e3) with decreasing magnitude
and (approximately) non-overlapping mantissas; arrays are four
equal-shape f64 arrays (struct-of-arrays, like DD).

Design: instead of the branchy renormalization of the reference QD
library (Hida-Li-Bailey 2001), all operations distill their exact
partial terms with a few error-free two_sum SWEEPS over the term list —
each sweep preserves the exact sum and drains mass upward, so the
leading four limbs converge to the non-overlapping representation.
Branch-free, elementwise, vectorizes on any backend.  Full precision
needs a correctly-rounded f64 multiply (IEEE f64 on the CPU and on
NVIDIA GPUs; an emulated f64 is not); the defect pipeline runs its
qd integrand on the host platform.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .dd import DD, two_prod, two_sum

__all__ = ["QD", "qd", "qd_add", "qd_sub", "qd_neg", "qd_abs", "qd_mul",
           "qd_mul_f64", "qd_div", "qd_sum", "qd_dot", "qd_from_dd",
           "qd_to_dd", "qd_to_float", "qd_from_string", "qd_to_string",
           "qd_gather_tt", "qd_contract", "qd_from_mp", "qd_to_mp",
           "qd_zeros", "qd_get", "qd_concat", "qd_vdot_axis", "qd_matmul",
           "qd_mag10", "qd_tt_value", "qd_exp"]


class QD(NamedTuple):
    e0: jax.Array
    e1: jax.Array
    e2: jax.Array
    e3: jax.Array

    @property
    def shape(self):
        return jnp.shape(self.e0)


def _ns(x):
    """Array namespace dispatch: every qd op runs on EITHER backend —
    jax for traced/device use, raw numpy for the host tier.  The numpy
    path matters: the defect pipeline's integrand does ~10^4 elementwise
    ops per evaluation, which as an XLA CPU graph is slow to compile and
    to dispatch, while numpy ufuncs run it at C speed with no compile (error-free transforms only need IEEE
    f64 arithmetic, which both provide)."""
    return jnp if isinstance(x, jax.Array) else np


def qd(e0, e1=0.0, e2=0.0, e3=0.0) -> QD:
    xp = _ns(e0)
    e0 = xp.asarray(e0, xp.float64)
    z = lambda v: xp.broadcast_to(xp.asarray(v, xp.float64), e0.shape)
    return QD(e0, z(e1), z(e2), z(e3))


def _distill(terms, passes: int = 4) -> QD:
    """Reduce a list of f64 terms (exact-sum representation) to a QD:
    `passes` BOTTOM-UP VecSum sweeps of adjacent two_sum.  Each sweep is
    an error-free transform of the list (the total is preserved
    exactly), and because it runs from the smallest slot upward, the
    running sum propagates all the way to the top in ONE pass — after
    pass k the leading k limbs are the faithful prefix of the total
    (Ogita-Rump-Oishi VecSum).  Four passes give four non-overlapping
    limbs; the remaining tail sits below ulp(e3) and is folded in
    plainly."""
    t = list(terms)
    K = len(t)
    for _ in range(passes):
        for i in range(K - 2, -1, -1):
            t[i], t[i + 1] = two_sum(t[i], t[i + 1])
    tail = t[3]
    for x in t[4:]:
        tail = tail + x
    return QD(t[0], t[1], t[2], tail)


def qd_neg(x: QD) -> QD:
    return QD(-x.e0, -x.e1, -x.e2, -x.e3)


def qd_abs(x: QD) -> QD:
    xp = _ns(x.e0)
    neg = x.e0 < 0
    f = lambda v: xp.where(neg, -v, v)
    return QD(f(x.e0), f(x.e1), f(x.e2), f(x.e3))


def qd_add(x: QD, y: QD) -> QD:
    """x + y: merge the eight limbs magnitude-interleaved and distill."""
    return _distill([x.e0, y.e0, x.e1, y.e1, x.e2, y.e2, x.e3, y.e3])


def qd_sub(x: QD, y: QD) -> QD:
    return qd_add(x, qd_neg(y))


def qd_mul(x: QD, y: QD) -> QD:
    """x * y: all error-free partial products up to order 3 (plus the
    order-4 cross terms folded in plainly — they sit ~2^-212 below the
    result) distilled to four limbs."""
    p00, q00 = two_prod(x.e0, y.e0)
    p01, q01 = two_prod(x.e0, y.e1)
    p10, q10 = two_prod(x.e1, y.e0)
    p02, q02 = two_prod(x.e0, y.e2)
    p11, q11 = two_prod(x.e1, y.e1)
    p20, q20 = two_prod(x.e2, y.e0)
    p03 = x.e0 * y.e3
    p12 = x.e1 * y.e2
    p21 = x.e2 * y.e1
    p30 = x.e3 * y.e0
    o4 = x.e1 * y.e3 + x.e2 * y.e2 + x.e3 * y.e1
    return _distill([p00,
                     p01, p10, q00,
                     p02, p11, p20, q01, q10,
                     p03, p12, p21, p30, q02, q11, q20,
                     o4])


def qd_mul_f64(x: QD, b) -> QD:
    """x * b with f64 b (each partial error-free)."""
    xp = _ns(x.e0)
    b = xp.asarray(b, xp.float64)
    p0, q0 = two_prod(x.e0, b)
    p1, q1 = two_prod(x.e1, b)
    p2, q2 = two_prod(x.e2, b)
    p3 = x.e3 * b
    return _distill([p0, p1, q0, p2, q1, p3, q2])


def qd_div(x: QD, y: QD) -> QD:
    """Long division (the HLB scheme): five quotient limbs, each from the
    leading limb of the running residual, then distill."""
    q0 = x.e0 / y.e0
    r = qd_sub(x, qd_mul_f64(y, q0))
    q1 = r.e0 / y.e0
    r = qd_sub(r, qd_mul_f64(y, q1))
    q2 = r.e0 / y.e0
    r = qd_sub(r, qd_mul_f64(y, q2))
    q3 = r.e0 / y.e0
    r = qd_sub(r, qd_mul_f64(y, q3))
    q4 = r.e0 / y.e0
    return _distill([q0, q1, q2, q3, q4])


def qd_from_dd(x: DD) -> QD:
    return QD(x.hi, x.lo, jnp.zeros_like(x.hi), jnp.zeros_like(x.hi))


def qd_to_dd(x: QD) -> DD:
    return DD(x.e0, x.e1 + (x.e2 + x.e3))


def qd_to_float(x: QD):
    return x.e0 + (x.e1 + (x.e2 + x.e3))


def qd_sum(x: QD, axis=None) -> QD:
    """Compensated reduction by an UNROLLED pairwise tree (log2 K qd_add
    levels): each level is exact to qd precision, the tree conditioning
    beats sequential accumulation, and — unlike a lax.scan — the graph
    stays small enough to nest inside the engine's fused while_loop
    without blowing up XLA compile time (the dd tier's scan was fine; a
    qd_add is ~30 two_sums)."""
    xp = _ns(x.e0)
    if axis is not None:
        limbs = [xp.moveaxis(e, axis, 0) for e in x]
    else:
        limbs = [e.reshape(-1) for e in x]
    K = limbs[0].shape[0]
    cur = QD(*limbs)
    while K > 1:
        half = (K + 1) // 2
        lo = QD(*(e[:K - half] for e in cur))
        hi = QD(*(e[half:K] for e in cur))
        merged = qd_add(lo, hi)
        if K % 2 == 1:   # middle element rides along unpaired
            mid = QD(*(e[half - 1:half] for e in cur))
            cur = QD(*(xp.concatenate([m, s], axis=0)
                       for m, s in zip(merged, mid)))
        else:
            cur = merged
        K = half
    return QD(*(e[0] for e in cur))


def qd_dot(x: QD, y: QD) -> QD:
    return qd_sum(qd_mul(x, y))


# ---------------------------------------------------------------- host side

def qd_from_mp(v) -> tuple[float, float, float, float]:
    """Split an mpmath mpf (or float/str at current dps) into four f64
    limbs by repeated subtraction (needs mp.dps >= ~70 for full qd
    precision)."""
    from mpmath import mp, mpf

    v = mpf(v)
    limbs = []
    for _ in range(4):
        h = float(v)
        limbs.append(h)
        v = v - mpf(h)
    return tuple(limbs)


def qd_to_mp(e0, e1=0.0, e2=0.0, e3=0.0):
    """Exact mpmath value of the limb sum (at current mp.dps)."""
    from mpmath import mpf

    return mpf(float(e0)) + mpf(float(e1)) + mpf(float(e2)) + mpf(float(e3))


def qd_from_string(s: str) -> tuple[float, float, float, float]:
    from mpmath import mp, workdps

    with workdps(max(mp.dps, 80)):
        return qd_from_mp(s)


def qd_to_string(x: QD, dps: int = 65) -> str:
    from mpmath import mp, workdps

    with workdps(dps):
        return mp.nstr(qd_to_mp(*(np.asarray(e) for e in x)), dps)


# ------------------------------------------------------------- qd exp

_EXP_CONSTS = None


def _exp_consts():
    global _EXP_CONSTS
    if _EXP_CONSTS is None:
        from mpmath import mp, mpf, workdps

        with workdps(80):
            ln2 = qd_from_mp(mp.log(2))
            inv_fact = [qd_from_mp(mpf(1) / mp.factorial(k))
                        for k in range(2, 20)]
        _EXP_CONSTS = (ln2, inv_fact)
    return _EXP_CONSTS


def qd_exp(x: QD) -> QD:
    """Quad-double exponential, elementwise over any shape (the qd
    extension of ops.dd.dd_exp — MPFUN's mp exp role, enabling qd
    integrands like exp(-sum x^2) in the qd cross engine).

    Scheme (the qd-library one): range-reduce x = k ln2 + r, scale r by
    2^-9 (exact), Horner the 1/k! Taylor tail at qd precision, square 9
    times, ldexp by k.  Measured max relative error ~2e-62 for results
    with |exp(x)| >= ~1e-260; below that the low limbs go subnormal and
    precision tapers to the f64 floor (a representation limit: e3 sits
    ~1e-48 under e0).  Host/CPU accurate like all qd ops; saturates at
    the f64 range (host tier — the traced/device path is degraded
    anyway, see module doc)."""
    xp = _ns(x.e0)
    ln2, inv_fact = _exp_consts()
    k = xp.round(x.e0 / ln2[0])
    ln2q = QD(*(xp.full_like(x.e0, c) for c in ln2))
    r = qd_sub(x, qd_mul(qd(k), ln2q))
    scale = 1.0 / 512.0
    r = QD(r.e0 * scale, r.e1 * scale, r.e2 * scale, r.e3 * scale)  # exact
    p = QD(*(xp.full_like(x.e0, c) for c in inv_fact[-1]))
    for c4 in reversed(inv_fact[:-1]):
        p = qd_add(qd_mul(p, r), QD(*(xp.full_like(x.e0, c) for c in c4)))
    p = qd_mul(qd_mul(p, r), r)          # sum_{k>=2} r^k / k!
    p = qd_add(p, r)
    s = qd_add(p, qd(xp.ones_like(x.e0)))
    for _ in range(9):
        s = qd_mul(s, s)
    if xp is np:
        with np.errstate(over="ignore"):   # saturated lanes clamp below
            pow2 = np.ldexp(np.ones_like(x.e0), k.astype(np.int64))
    else:
        from .dd import _exact_pow2

        pow2 = _exact_pow2(k)
    out = QD(s.e0 * pow2, s.e1 * pow2, s.e2 * pow2, s.e3 * pow2)  # exact
    floor, ceil = -708.0, 709.0          # binary64 exp(x) range
    z = xp.zeros_like(x.e0)
    sat = (x.e0 < floor) | (x.e0 > ceil)
    e0 = xp.where(x.e0 < floor, z, xp.where(x.e0 > ceil, xp.inf, out.e0))
    return QD(e0, xp.where(sat, z, out.e1), xp.where(sat, z, out.e2),
              xp.where(sat, z, out.e3))


# ------------------------------------------------- ragged-array helpers
# Structural ops for the host qd cross engine (cross/engine_qd.py): all
# work on either backend, but the engine runs them on numpy (ragged
# rank-growing arrays, like engine_mp's object arrays).

def qd_zeros(shape, xp=np) -> QD:
    z = xp.zeros(shape)
    return QD(z, xp.zeros_like(z), xp.zeros_like(z), xp.zeros_like(z))


def qd_get(x: QD, idx) -> QD:
    """Limb-wise indexing/slicing: qd_get(x, (i, j)) == x[i, j]."""
    return QD(x.e0[idx], x.e1[idx], x.e2[idx], x.e3[idx])


def qd_concat(parts, axis=0) -> QD:
    xp = _ns(parts[0].e0)
    return QD(*(xp.concatenate([xp.atleast_1d(p[i]) for p in parts],
                               axis=axis) for i in range(4)))


def qd_vdot_axis(a: QD, v: QD, axis: int) -> QD:
    """Contract one axis of a qd tensor against a qd vector (the
    np.tensordot(a, v, axes=[[axis], [0]]) pattern of the mp engine):
    broadcast-multiply along `axis` moved last, then qd_sum it."""
    xp = _ns(a.e0)
    am = QD(*(xp.moveaxis(e, axis, -1) for e in a))
    nd = am.e0.ndim - 1
    vb = QD(*(e.reshape((1,) * nd + (-1,)) for e in v))
    return qd_sum(qd_mul(am, QD(*(xp.broadcast_to(e, am.e0.shape)
                                  for e in vb))), axis=-1)


def qd_matmul(a: QD, b: QD) -> QD:
    """(m, k) @ (k, n) in qd.

    Accumulates rank-1 terms over the inner axis instead of materializing
    the (m, k, n) broadcast: a qd_mul is ~130 elementwise passes, so the
    broadcast formulation moves m*k*n*4 f64 through memory ~130 times —
    at the cross engine's core-solve shapes (r, r) @ (r, n*r) that was
    the single hottest spot of a whole cross (profiled ~80% of wall).
    The k-loop does the same flops on (m, n)-sized temporaries (each
    qd_add merge is an error-free distill, so accumulation order only
    moves the ~1e-64 tail)."""
    m, k = a.e0.shape
    n = b.e0.shape[1]
    acc = None
    for t in range(k):
        term = qd_mul(QD(*(e[:, t, None] for e in a)),
                      QD(*(e[None, t, :] for e in b)))
        acc = term if acc is None else qd_add(acc, term)
    if acc is None:
        return qd_zeros((m, n), _ns(a.e0))
    return acc


def qd_mag10(x: QD):
    """log10|x| from the leading limb; -inf at exact zero (the log-domain
    magnitude used for thresholds, dmrggmp.f90:50-53)."""
    xp = _ns(x.e0)
    with np.errstate(divide="ignore"):
        return xp.log10(xp.abs(x.e0))


def qd_tt_value(cores, w) -> QD:
    """Plain quadrature contraction of a solved qd train against qd
    per-mode weights (mptt_quad, dmrggmp.f90:778-888): cores: list of QD
    (r, n_c, r'); w: list of QD (>= n_c,)."""
    v = None
    for c, G in enumerate(cores):
        M = qd_vdot_axis(G, qd_get(w[c], slice(0, G.e0.shape[1])), 1)
        v = M if v is None else qd_matmul(v, M)
    return qd_get(v, (0, 0))


# ------------------------------------------------------------ TT evaluation

def qd_gather_tt(t, ind) -> QD:
    """Evaluate an f64 TT at (B, d) indices with all accumulation in qd
    (the chain of matvecs through qd_mul/qd_sum carries ~62 significant
    digits of the exact product of the stored f64 cores).  Jittable, or
    pure numpy when `ind` is numpy (the host defect tier — pass cores as
    numpy too); the defect integrand uses this (cross/defect.py)."""
    xp = _ns(ind)
    ind = xp.asarray(ind)
    B = ind.shape[0]
    z = xp.zeros((B, 1))
    v = QD(xp.ones((B, 1)), z, z, z)
    for c in range(t.d):
        g = xp.take(xp.asarray(t.cores[c]), ind[:, c], axis=1)  # (r, B, r2)
        g = xp.moveaxis(g, 1, 0)                             # (B, r, r2)
        zg = xp.zeros_like(g)
        prod = qd_mul(QD(v.e0[:, :, None], v.e1[:, :, None],
                         v.e2[:, :, None], v.e3[:, :, None]),
                      QD(g, zg, zg, zg))                     # (B, r, r2)
        v = qd_sum(prod, axis=1)                             # (B, r2)
    return QD(v.e0[:, 0], v.e1[:, 0], v.e2[:, 0], v.e3[:, 0])


def qd_contract(t, weights: list) -> QD:
    """Contract an f64 TT against per-mode qd weight vectors entirely in
    qd (the mptt_quad role at the 62-digit tier; the __float128 host path
    native.contract_q caps at ~33 digits).  weights: list of QD arrays
    (n_c,); runs on the weights' backend (numpy or jax)."""
    xp = _ns(weights[0].e0)
    v = None
    for c in range(t.d):
        g = xp.asarray(t.cores[c])                           # (r1, n, r2)
        w = weights[c]
        zg = xp.zeros_like(g)
        gw = qd_mul(QD(g, zg, zg, zg),
                    QD(w.e0[None, :, None], w.e1[None, :, None],
                       w.e2[None, :, None], w.e3[None, :, None]))
        m = qd_sum(gw, axis=1)                               # (r1, r2)
        if v is None:
            v = QD(m.e0[0], m.e1[0], m.e2[0], m.e3[0])       # (r2,)
        else:
            prod = qd_mul(QD(v.e0[:, None], v.e1[:, None],
                             v.e2[:, None], v.e3[:, None]), m)
            v = qd_sum(prod, axis=0)                         # (r2,)
    return QD(v.e0[0], v.e1[0], v.e2[0], v.e3[0])
