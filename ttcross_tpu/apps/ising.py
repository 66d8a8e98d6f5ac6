"""Ising susceptibility integrands C_m / D_m / E_m.

Batched redesign of dfunc_ising_discr (test_crs_ising.f90:176-218).
The reference evaluates one multi-index at a time with O(d^2) nested scalar
loops; here the integrand is batched over a (B, d) index matrix and the
pairwise product structure is vectorized:

  with node values x_1..x_d and prefix products P_0..P_d (P_0 = 1,
  P_j = x_1...x_j), the nested quantity u_ij = prod_{t=i+1..j} x_t equals
  P_j / P_i, so the a-term prod_{i<j} ((u_ij-1)/(u_ij+1))^2 becomes a masked
  pairwise reduction over the (d+1)x(d+1) prefix outer ratio -- pure vector
  work; the b-term 1/(v w) uses prefix and suffix cumulative sums of
  products.

Conventions follow the driver (test_crs_ising.f90): the integral "C_m" is
discretized over d = m-1 variables (tt%m = m-1, line 147); the integrand
multiplies the per-dimension quadrature weights itself (lines 214-217),
while the rank-1 quad tensor carries only the underflow-rescaling factors
1/val with the weights pre-multiplied by val (lines 134-144).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.quadrature import lgwt

__all__ = ["IsingProblem", "make_ising", "ising_integrand"]

_KIND_ID = {"C": 1, "D": 2, "E": 3}


def _cumprod(x, axis: int = 1):
    """Cumulative product for integrand chains.  jnp.cumprod may lower to
    a growing-window reduce-window — O(d^2) work per row (it did on the
    first target); lax.associative_scan is the log2(d)-pass O(d log d) form: same
    product values up to rounding order."""
    if x.shape[axis] <= 32:
        return jnp.cumprod(x, axis=axis)
    return jax.lax.associative_scan(jnp.multiply, x, axis=axis)


def ising_integrand(ind, nodes, weights, kind: str):
    """Batched Ising integrand: ind (B, d) int32 -> (B,) values.

    kind 'C' -> 2b, 'D' -> 2ab, 'E' -> 2a, each times prod of weights
    (ids 1/2/3 in test_crs_ising.f90:206-212)."""
    kid = _KIND_ID[kind.upper()]
    from ..ops.dense import table_lookup

    x = table_lookup(nodes, ind)     # (B, d)
    w = table_lookup(weights, ind)
    B, d = x.shape
    one = jnp.ones((B, 1), dtype=x.dtype)

    f = jnp.full((B,), 2.0, dtype=x.dtype)
    if kid in (2, 3):  # a-term
        P = jnp.concatenate([one, _cumprod(x, axis=1)], axis=1)  # (B, d+1)
        if d <= 96:
            num = P[:, None, :] - P[:, :, None]   # P_j - P_i at [b, i, j]
            den = P[:, None, :] + P[:, :, None]
            ratio = jnp.where(den == 0, 0.0, num / den) ** 2
            iu = jnp.triu(jnp.ones((d + 1, d + 1), dtype=bool), k=1)
            a = jnp.prod(jnp.where(iu[None, :, :], ratio, 1.0), axis=(1, 2))
        else:
            # large d: scan over j keeps memory at O(B d) instead of O(B d^2)
            jdx = jnp.arange(d + 1)

            def step(acc, j):
                col = P[:, j]
                r = jnp.where((jdx[None, :] < j) & (col[:, None] + P != 0),
                              (col[:, None] - P) / (col[:, None] + P), 1.0)
                return acc * jnp.prod(r * r, axis=1), None

            a, _ = jax.lax.scan(step, jnp.ones((B,), x.dtype), jdx)
        f = f * a
    if kid in (1, 2):  # b-term
        pre = _cumprod(x, axis=1)                # prefix products
        suf = _cumprod(x[:, ::-1], axis=1)       # suffix products
        v = 1.0 + jnp.sum(suf, axis=1)
        wv = 1.0 + jnp.sum(pre, axis=1)
        f = f / (v * wv)
    return f * jnp.prod(w, axis=1)


def ising_c_chain(nodes, weights):
    """ChainSpec (cross/chain_eval.py) for the C-kind integrand: the
    value 2/(v·w)·∏W (test_crs_ising.f90:176-218, b-term only) factors
    through the 4-component monoid

        (P, A, Q, W):  P = ∏ x_i          (block node product)
                       A = Σ_k ∏_{i≤k} x_i  (prefix-product sums)
                       Q = Σ_k ∏_{i≥k} x_i  (suffix-product sums)
                       W = ∏ W_i          (block weight product)

    with merge (L, R) -> (P_L P_R, A_L + P_L A_R, Q_R + P_R Q_L,
    W_L W_R) and finalize 2W/((1+A)(1+Q)).  The engine's hunt then
    evaluates candidates in O(1) from cached interface states instead
    of O(d) — see cross/chain_eval.py.  Partial products stay in range:
    nodes ∈ [0,1] and max-normalized weights ≤ 1, so every partial is
    bounded by 1 in magnitude and at least the full product (which the
    rescaling already keeps representable).

    The D/E a-term ∏_{i<j}((P_j-P_i)/(P_j+P_i))² needs all prefix
    values — not O(1)-state expressible — so only kind C gets a spec."""
    from ..cross.chain_eval import ChainSpec
    from ..ops.dense import table_lookup

    nodes = jnp.asarray(nodes)
    weights = jnp.asarray(weights)

    def identity():
        return dict(P=1.0, A=0.0, Q=0.0, W=1.0)

    def lift(dims, idx):
        del dims  # mode tables are uniform for the Ising grid
        idx = jnp.asarray(idx)
        x = table_lookup(nodes, idx)
        w = table_lookup(weights, idx)
        return dict(P=x, A=x, Q=x, W=w)

    def merge(a, b):
        return dict(P=a["P"] * b["P"],
                    A=a["A"] + a["P"] * b["A"],
                    Q=b["Q"] + b["P"] * a["Q"],
                    W=a["W"] * b["W"])

    def finalize(s):
        return 2.0 * s["W"] / ((1.0 + s["A"]) * (1.0 + s["Q"]))

    return ChainSpec(identity, lift, merge, finalize)


def ising_integrand_np(ind, nodes, weights, kind: str) -> np.ndarray:
    """Host-numpy twin of ising_integrand: ind (B, d) int -> (B,) f64.

    Exists for accurate host re-evaluation at a frozen skeleton
    (cross/skeleton.py::reevaluate_host)."""
    kid = _KIND_ID[kind.upper()]
    ind = np.asarray(ind)
    x = np.asarray(nodes)[ind]       # (B, d)
    w = np.asarray(weights)[ind]
    B, d = x.shape

    f = np.full(B, 2.0)
    if kid in (2, 3):  # a-term: prod_{i<j} ((P_j/P_i - 1)/(P_j/P_i + 1))^2
        P = np.concatenate([np.ones((B, 1)), np.cumprod(x, axis=1)], axis=1)
        num = P[:, None, :] - P[:, :, None]
        den = P[:, None, :] + P[:, :, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(den == 0, 0.0, num / den) ** 2
        iu = np.triu(np.ones((d + 1, d + 1), dtype=bool), k=1)
        f = f * np.prod(np.where(iu[None], ratio, 1.0), axis=(1, 2))
    if kid in (1, 2):  # b-term: 1 / ((1 + sum suffix prods)(1 + sum prefix))
        v = 1.0 + np.cumprod(x[:, ::-1], axis=1).sum(axis=1)
        wv = 1.0 + np.cumprod(x, axis=1).sum(axis=1)
        f = f / (v * wv)
    return f * np.prod(w, axis=1)


def ising_c_integrand_dd(ind, nodes_dd, weights_dd):
    """C-kind Ising integrand evaluated in DEVICE double-double arithmetic:
    f = 2/(v w) prod_i W_i with the telescoping prefix/suffix product sums
    computed as dd scans (the device-side twin of native.ising_c_dd, and
    the fun_dd for the defect-correction pipeline).  Returns DD (B,)."""
    import jax

    from ..ops.dd import DD, dd, dd_add, dd_div, dd_mul

    ind = jnp.asarray(ind)
    B = ind.shape[0]
    xh = nodes_dd.hi[ind]
    xl = nodes_dd.lo[ind]

    def cum_sum_of_prods(h, w):
        """1 + sum_k prod_{i<=k} x_i over axis 1, in dd (scan over modes)."""

        def step(carry, xt):
            pk, s = carry
            pk = dd_mul(pk, xt)
            s = dd_add(s, pk)
            return (pk, s), None

        init = (dd(jnp.ones(B)), dd(jnp.ones(B)))
        (pk, s), _ = jax.lax.scan(step, init, DD(h.T, w.T))
        return s

    w_sum = cum_sum_of_prods(xh, xl)
    v_sum = cum_sum_of_prods(xh[:, ::-1], xl[:, ::-1])
    b = dd_div(dd(jnp.full(B, 2.0)), dd_mul(v_sum, w_sum))

    gh = weights_dd.hi[ind]
    gl = weights_dd.lo[ind]

    def stepw(carry, wt):
        return dd_mul(carry, wt), None

    prodw, _ = jax.lax.scan(stepw, dd(jnp.ones(B)), DD(gh.T, gl.T))
    return dd_mul(b, prodw)


def make_ising_dd(m: int = 6, n: int = 65):
    """Ising C_m problem with dd quadrature data (__float128 rule): returns
    (prob_f64, fun_dd, weights_hi, weights_lo) for the defect-correction
    pipeline (cross/defect.py).  The f64 problem's nodes/weights are the hi
    parts so TT1 approximates the same dd-sampled tensor to f64."""
    from .. import native
    from ..ops.dd import DD, dd, dd_add, dd_mul

    if n % 2 == 0:
        n += 1
    d = m - 1
    (xh, xl), (wh, wl) = native.gauss_legendre_dd(n)
    half = dd(0.5)
    Xn = dd_mul(dd_add(DD(jnp.asarray(xh), jnp.asarray(xl)), dd(1.0)), half)
    val = float(n // 2)
    Wn = dd_mul(DD(jnp.asarray(wh), jnp.asarray(wl)), dd(0.5 * val))

    nodes = np.asarray(Xn.hi)
    weights = np.asarray(Wn.hi)
    quad_weights = np.full(n, 1.0 / val)
    from .truths import ising_truth

    prob = IsingProblem(kind="C", m=m, d=d, n=n, nodes=nodes, weights=weights,
                        quad_weights=quad_weights, truth=ising_truth("C", m))

    def fun_dd(ind):
        return ising_c_integrand_dd(ind, Xn, Wn)

    weights_hi = [quad_weights] * d
    weights_lo = [np.zeros(n)] * d
    return prob, fun_dd, weights_hi, weights_lo


def ising_c_integrand_qd(ind, nodes_qd, weights_qd):
    """C-kind Ising integrand in quad-double arithmetic (~62 digits): the
    qd twin of ising_c_integrand_dd for the three-level defect pipeline
    (cross/defect.py) — same telescoping prefix/suffix product sums, qd
    scans.  Returns QD (B,)."""
    from ..ops.qd import QD, qd, qd_add, qd_div, qd_mul

    xp = jnp if isinstance(ind, jax.Array) else np   # numpy host tier OK
    ind = xp.asarray(ind)
    B, d = ind.shape
    xt = QD(*(xp.asarray(e)[ind] for e in nodes_qd))         # (B, d) limbs

    # unrolled over the (small) mode count: a lax.scan of qd ops nested
    # inside the engine's fused while_loop made XLA CPU compilation of
    # the defect-level cross minutes-long; unrolling keeps the graph
    # linear in d and compiles ~10x faster
    def cum_sum_of_prods(x):
        pk = qd(xp.ones(B))
        s = qd(xp.ones(B))
        for c in range(d):
            pk = qd_mul(pk, QD(*(e[:, c] for e in x)))
            s = qd_add(s, pk)
        return s

    w_sum = cum_sum_of_prods(xt)
    v_sum = cum_sum_of_prods(QD(*(e[:, ::-1] for e in xt)))
    b = qd_div(qd(xp.full(B, 2.0)), qd_mul(v_sum, w_sum))

    gt = QD(*(xp.asarray(e)[ind] for e in weights_qd))
    prodw = qd(xp.ones(B))
    for c in range(d):
        prodw = qd_mul(prodw, QD(*(e[:, c] for e in gt)))
    return qd_mul(b, prodw)


def make_ising_qd(m: int = 6, n: int = 65, dps: int = 80):
    """Ising C_m problem with quad-double quadrature data (mp_lgwt rule
    split into four limbs): returns (prob_f64, fun_qd, weights_qd) for
    the three-level defect pipeline.  The f64 problem's nodes/weights are
    the leading limbs so TT1 approximates the same qd-sampled tensor to
    f64 (the defect then sits at ~1e-14 |A|)."""
    from ..ops.mp import mp_lgwt
    from ..ops.qd import QD, qd, qd_from_mp

    if n % 2 == 0:
        n += 1
    d = m - 1
    from mpmath import mpf, workdps

    with workdps(dps):
        x, w = mp_lgwt(n, dps)
        val = n // 2
        Xl = np.array([qd_from_mp((xi + 1) / 2) for xi in x])    # (n, 4)
        Wl = np.array([qd_from_mp(wi * mpf(val) / 2) for wi in w])
    # limb tables stay HOST numpy: a jnp.asarray here would land them on
    # the default device, where the f32-pair f64 emulation corrupts the
    # ~1e-33/1e-50 low limbs (exponent range) and every host-tier eval
    # would pay a device->host fetch; the traced path converts at trace
    # time instead
    Xn = QD(*(np.ascontiguousarray(Xl[:, i]) for i in range(4)))
    Wn = QD(*(np.ascontiguousarray(Wl[:, i]) for i in range(4)))

    nodes = np.asarray(Xl[:, 0])
    weights = np.asarray(Wl[:, 0])
    quad_weights = np.full(n, 1.0 / val)    # 1/(n//2) is exact in f64
    from .truths import ising_truth

    prob = IsingProblem(kind="C", m=m, d=d, n=n, nodes=nodes,
                        weights=weights, quad_weights=quad_weights,
                        truth=ising_truth("C", m))

    def fun_qd(ind):
        return ising_c_integrand_qd(ind, Xn, Wn)

    with workdps(dps):
        wq = np.array([qd_from_mp(mpf(1) / val)] * n)        # (n, 4) exact
    weights_qd = [QD(*(np.ascontiguousarray(wq[:, i]) for i in range(4)))] * d
    return prob, fun_qd, weights_qd


def make_ising_mp(kind: str = "C", m: int = 4, n: int = 33, dps: int = 120):
    """Ising problem at arbitrary precision (the test_mpf_ising role,
    README.md:52, data plane of mptt_dmrgg): mp Gauss-Legendre rule on
    [0, 1], mp integrand, mp rank-1 quad weights, mp truth.

    Returns (d, n, fun_mp, quad_w, truth_mp).  fun_mp: (B, d) int ->
    (B,) object array of mpf, evaluated at mp.dps = dps."""
    from mpmath import mp, mpf

    from ..ops.mp import mp_lgwt, workdps
    from .truths import ising_truth_mp

    kind = kind.upper()
    if kind not in _KIND_ID:
        raise ValueError(f"unknown Ising integral kind: {kind}")
    kid = _KIND_ID[kind]
    if n % 2 == 0:
        n += 1
    d = m - 1
    with workdps(dps):
        x, w = mp_lgwt(n, dps)
        half = mpf(1) / 2
        nodes = np.array([(xi + 1) * half for xi in x], dtype=object)
        val = mpf(n // 2)
        weights = np.array([wi * half * val for wi in w], dtype=object)
        quad_w = np.array([1 / val] * n, dtype=object)
        try:
            truth = ising_truth_mp(kind, m, dps)
        except KeyError:
            truth = None

    def fun_mp(ind):
        """dfunc_ising_discr (test_crs_ising.f90:176-218) in mp arithmetic."""
        with workdps(dps):
            B = ind.shape[0]
            out = np.empty(B, dtype=object)
            for t in range(B):
                xs = [nodes[ind[t, s]] for s in range(d)]
                f = mpf(2)
                if kid in (2, 3):  # a-term: prod_{i<j} ((u-1)/(u+1))^2
                    P = [mpf(1)]
                    for v in xs:
                        P.append(P[-1] * v)
                    a = mpf(1)
                    for i in range(d + 1):
                        for j in range(i + 1, d + 1):
                            ratio = (P[j] - P[i]) / (P[j] + P[i])
                            a *= ratio * ratio
                    f *= a
                if kid in (1, 2):  # b-term: 2/(v w)
                    pre = mpf(1)
                    wsum = mpf(1)
                    for v in xs:
                        pre *= v
                        wsum += pre
                    suf = mpf(1)
                    vsum = mpf(1)
                    for v in reversed(xs):
                        suf *= v
                        vsum += suf
                    f /= vsum * wsum
                for s in range(d):
                    f *= weights[ind[t, s]]
                out[t] = f
            return out

    return d, n, fun_mp, [quad_w] * d, truth


@dataclass(frozen=True)
class IsingProblem:
    """Problem bundle: batched integrand, rank-1 quad weights, truth."""

    kind: str
    m: int                    # integral index (C_m / D_m / E_m)
    d: int                    # TT dimension = m - 1
    n: int                    # quadrature size (odd)
    nodes: np.ndarray         # (n,) Gauss-Legendre nodes mapped to [0, 1]
    weights: np.ndarray       # (n,) rescaled weights applied by the integrand
    quad_weights: np.ndarray  # (n,) per-mode entries of the rank-1 quad tensor
    truth: float | None = None
    rescale: bool = field(default=False)

    def fun(self, ind):
        return ising_integrand(ind, jnp.asarray(self.nodes), jnp.asarray(self.weights), self.kind)

    def fun_np(self, ind):
        """Host-numpy twin (accurate f64 on platforms with emulated
        device f64; see ising_integrand_np)."""
        return ising_integrand_np(ind, self.nodes, self.weights, self.kind)

    @functools.cached_property
    def chain(self):
        """ChainSpec for O(1) hunt-candidate evaluation (C-kind only;
        pass as cross(..., chain=prob.chain)).  Cached so repeated
        accesses return the SAME spec object — the engine cache keys on
        its identity (a fresh spec per access would recompile)."""
        if self.kind.upper() != "C":
            return None
        return ising_c_chain(self.nodes, self.weights)


def make_ising(kind: str = "C", m: int = 6, n: int = 65) -> IsingProblem:
    """Build the discretized Ising problem exactly as the reference driver
    does (test_crs_ising.f90:102-144): Gauss-Legendre on [0,1] with the
    measure normalization, plus underflow rescaling for D/E with m >= 10."""
    kind = kind.upper()
    if kind not in _KIND_ID:
        raise ValueError(f"unknown Ising integral kind: {kind}")
    if n % 2 == 0:
        n += 1  # the driver adjusts even n (test_crs_ising.f90:40)
    d = m - 1
    x, w = lgwt(n)
    w = 0.5 * w                 # make it a measure on [0,1]
    x = (x + 1.0) / 2.0         # [-1,1] -> [0,1]
    rescale = kind in ("D", "E") and m >= 10
    val = 5.0 * (n // 2) if rescale else float(n // 2)
    if m >= 32:
        # long chains: products of d ~ m per-dimension weights leave the
        # floating range (0.5^255 ~ 1e-77 with the default scaling; and a
        # geometric-mean normalization still lets the all-center-node
        # corner overflow, 1.53^255 ~ 1e47 — fatal on the f32-pair f64
        # emulation whose range ends at ~3.4e38).  Normalizing by the MAX
        # weight bounds every product by 1: no overflow ever, and only
        # entries >38 orders below the largest — irrelevant to the
        # quadrature — flush to zero.  The same keep-it-in-range trick as
        # the reference's D/E rescaling (test_crs_ising.f90:135-144),
        # chosen per-chain instead of the fixed 5*(n//2).
        val = float(1.0 / np.max(w))
        rescale = True
    weights = w * val
    quad_weights = np.full(n, 1.0 / val)

    from .truths import ising_truth

    try:
        truth = ising_truth(kind, m)
    except KeyError:
        truth = None
    return IsingProblem(kind=kind, m=m, d=d, n=n, nodes=x, weights=weights,
                        quad_weights=quad_weights, truth=truth, rescale=rescale)
