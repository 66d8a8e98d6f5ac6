"""Product standard-normal integrand: exp(-sum x^2) on [-10, 10]^d.

Maps the smoke-test driver test_crs_stdnorm.f90 (integrand at lines 154-170,
truth pi^(d/2) at line 83).  The integrand does not apply weights; they live
in the rank-1 quad tensor (lines 100-107).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..ops.quadrature import lgwt, map_to_interval

__all__ = ["StdnormProblem", "make_stdnorm", "make_stdnorm_dd",
           "make_stdnorm_qd",
           "stdnorm_integrand_dd"]


@dataclass(frozen=True)
class StdnormProblem:
    d: int
    n: int
    nodes: np.ndarray
    quad_weights: np.ndarray
    truth: float

    def fun(self, ind):
        from ..ops.dense import table_lookup

        x = table_lookup(self.nodes, ind)     # (B, d)
        return jnp.exp(-jnp.sum(x * x, axis=1))


def make_stdnorm(d: int = 6, n: int = 65, a: float = -10.0, b: float = 10.0) -> StdnormProblem:
    if n % 2 == 0:
        n += 1
    x, w = lgwt(n)
    x, w = map_to_interval(x, w, a, b)
    return StdnormProblem(d=d, n=n, nodes=x, quad_weights=w, truth=float(np.pi) ** (d / 2))


def stdnorm_integrand_dd(ind, nodes_dd):
    """exp(-sum x^2) evaluated in DEVICE double-double arithmetic via the
    dd exponential (ops.dd.dd_exp) — the fun_dd for defect correction.
    Returns DD (B,)."""
    from ..ops.dd import DD, dd_exp, dd_mul, dd_neg, dd_sum

    ind = jnp.asarray(ind)
    x = DD(nodes_dd.hi[ind], nodes_dd.lo[ind])     # (B, d)
    s = dd_sum(dd_mul(x, x), axis=1)
    return dd_exp(dd_neg(s))


def make_stdnorm_dd(d: int = 6, n: int = 65, a: float = -10.0, b: float = 10.0):
    """stdnorm problem with dd quadrature data (__float128 GL rule):
    returns (prob_f64, fun_dd, weights_hi, weights_lo) for the
    defect-correction pipeline — the beyond-f64 tier for a transcendental
    (non-rational) integrand, exercising the device dd exp."""
    from .. import native
    from ..ops.dd import DD, dd, dd_add, dd_mul

    if n % 2 == 0:
        n += 1
    (xh, xl), (wh, wl) = native.gauss_legendre_dd(n)
    half_len = dd(0.5 * (b - a))
    mid = dd(0.5 * (b + a))
    Xn = dd_add(dd_mul(DD(jnp.asarray(xh), jnp.asarray(xl)), half_len),
                DD(jnp.broadcast_to(mid.hi, (n,)), jnp.broadcast_to(mid.lo, (n,))))
    Wn = dd_mul(DD(jnp.asarray(wh), jnp.asarray(wl)), half_len)

    prob = StdnormProblem(d=d, n=n, nodes=np.asarray(Xn.hi),
                          quad_weights=np.asarray(Wn.hi),
                          truth=float(np.pi) ** (d / 2))

    def fun_dd(ind):
        return stdnorm_integrand_dd(ind, Xn)

    weights_hi = [np.asarray(Wn.hi)] * d
    weights_lo = [np.asarray(Wn.lo)] * d
    return prob, fun_dd, weights_hi, weights_lo


def make_stdnorm_qd(d: int = 4, n: int = 201, a: float = -12.5,
                    b: float = 12.5, dps: int = 80):
    """stdnorm problem with quad-double quadrature data for the qd cross
    engine (cross/engine_qd.py): returns (prob_f64, fun_qd, weights_qd).

    The default box is WIDER than the reference's [-10, 10]
    (test_crs_stdnorm.f90:100-107) because the box itself truncates the
    Gaussian: int_{|x|>10} exp(-x^2) ~ 2e-45 caps any rule at ~44.7
    digits vs the pi^(d/2) truth, while [-12.5, 12.5] pushes that to
    ~6e-70 — below qd noise (n=201 GL reaches the same; measured).
    Limb tables stay host numpy (see make_ising_qd)."""
    from ..ops.mp import mp_lgwt
    from ..ops.qd import QD, qd_exp, qd_from_mp, qd_mul, qd_neg, qd_sum
    from mpmath import mpf, workdps

    if n % 2 == 0:
        n += 1
    with workdps(dps):
        x, w = mp_lgwt(n, dps)
        hl = (mpf(b) - mpf(a)) / 2
        mid = (mpf(b) + mpf(a)) / 2
        Xl = np.array([qd_from_mp(hl * xi + mid) for xi in x])     # (n, 4)
        Wl = np.array([qd_from_mp(wi * hl) for wi in w])
    Xn = QD(*(np.ascontiguousarray(Xl[:, i]) for i in range(4)))
    Wn = QD(*(np.ascontiguousarray(Wl[:, i]) for i in range(4)))

    prob = StdnormProblem(d=d, n=n, nodes=np.asarray(Xl[:, 0]),
                          quad_weights=np.asarray(Wl[:, 0]),
                          truth=float(np.pi) ** (d / 2))

    def fun_qd(ind):
        xp = jnp if not isinstance(ind, np.ndarray) else np
        ind = xp.asarray(ind)
        x = QD(*(xp.asarray(e)[ind] for e in Xn))                  # (B, d)
        s = qd_sum(qd_mul(x, x), axis=1)
        return qd_exp(qd_neg(s))

    weights_qd = [Wn] * d
    return prob, fun_qd, weights_qd
