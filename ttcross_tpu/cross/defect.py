"""Defect-corrected high-precision cross integration.

The device-first answer to the reference's multiprecision CROSS (mptt_dmrgg,
dmrggmp.f90): instead of running the whole greedy engine in software
arbitrary precision, exploit that pivot SELECTION only ever needs the
resolution of the current residual scale:

  1. cross the integrand A in the fast f64 engine         -> TT1 (err ~1e-14 |A|)
  2. cross the DEFECT g = A_dd - TT1, where A is evaluated in device
     double-double arithmetic and TT1 is chain-evaluated in dd
     (ops/dd.dd_gather_tt); g fits f64 with full precision because it is
     ~1e-14 |A| in magnitude                              -> TT2 (err ~1e-14 |g| ~ 1e-28 |A|)
  3. total = quad(TT1) + quad(TT2), both contracted against double-double
     quadrature weights in __float128 on host (native.contract_q)

Every expensive step (both crosses) runs in the ordinary f64 device engine;
dd arithmetic appears only inside the defect integrand.  The final accuracy
is limited by the quadrature rule and the second-level rank truncation —
~25-30 correct digits for the shipped integrands.

The integrand must supply a device-dd evaluation fun_dd(ind) -> DD.
"""

from __future__ import annotations

from .. import native
from ..ops.dd import DD, dd_gather_tt, dd_sub, dd_to_float
from .engine import cross

__all__ = ["cross_defect_corrected", "cross_defect_corrected_qd"]


class _Defect:
    """Residual integrand g = A_dd - sum of previous trains, evaluated in
    device dd arithmetic and returned as f64 (pinned callable so the engine
    cache keys it stably)."""

    def __init__(self, fun_dd, trains):
        self.fun_dd = fun_dd
        self.trains = tuple(trains)

    def __call__(self, ind):
        acc = self.fun_dd(ind)
        for t in self.trains:
            acc = dd_sub(acc, dd_gather_tt(t, ind))
        return dd_to_float(acc)


def cross_defect_corrected(
    fun, fun_dd, n, weights_hi, weights_lo,
    max_rank: int = 24, max_rank2: int | None = None,
    levels: int = 2,
    accuracy: float = 1e-13, pivoting: int = 1, key: int = 0,
    verbose: bool = False, mesh=None,
):
    """Multi-level defect-corrected cross quadrature.

    fun: f64 batched integrand (first cross).  fun_dd: the same integrand
    in device dd arithmetic (ind -> DD).  weights_*: per-mode dd
    quadrature weights.  levels: number of crosses (2 = classic defect
    correction; 3 adds a second correction over A - TT1 - TT2, limited
    by the ~1e-31 absolute noise of dd evaluation).
    mesh: optional 1-D bond mesh — every level's cross then runs on the
    distributed engine (the reference's mp tier is MPI-parallel,
    dmrggmp.f90:518-629; this is its defect-corrected analogue).
    Returns (hi, lo, info)."""
    n = [int(x) for x in n]
    max_rank2 = max_rank2 or max_rank

    trains = []
    nevals, ranks = [], []
    k = key
    for lvl in range(levels):
        if lvl == 0:
            f = fun
            r = max_rank
        else:
            f = _Defect(fun_dd, trains)
            r = max_rank2
        if mesh is not None:
            from ..parallel import cross_parallel

            res = cross_parallel(f, n, max_rank=r, accuracy=accuracy,
                                 pivoting=pivoting, key=k, mesh=mesh,
                                 verbose=verbose)
        else:
            res = cross(f, n, max_rank=r, accuracy=accuracy,
                        pivoting=pivoting, key=k, verbose=verbose)
        trains.append(res.tt)
        nevals.append(res.neval)
        ranks.append(res.ranks)
        k = k + 1 if isinstance(k, int) else k

    from decimal import Decimal, localcontext

    with localcontext() as ctx:
        ctx.prec = 50
        qs = []
        total = Decimal(0)
        for t in trains:
            h, l = native.contract_q(t, weights_hi, weights_lo)
            qs.append((h, l))
            total += Decimal(h) + Decimal(l)
        hi = float(total)
        lo = float(total - Decimal(hi))
    info = {
        "neval1": nevals[0], "neval2": sum(nevals[1:]),
        "nevals": nevals, "ranks": ranks,
        "ranks1": ranks[0], "ranks2": ranks[-1],
        "q1": qs[0], "q2": qs[-1], "qs": qs,
    }
    return hi, lo, info


class _DefectQD:
    """Residual integrand g = A_qd - sum of previous trains, evaluated in
    quad-double arithmetic (~62 digits) and returned as f64 (pinned
    callable so the engine cache keys it stably).

    The qd evaluation is fenced off behind jax.pure_callback and runs in
    raw NUMPY: a qd_mul is ~60 error-free transforms, so as a traced
    graph the integrand is ~10^4 elementwise ops — slow for XLA CPU to
    compile and to dispatch, while numpy ufuncs run the identical
    IEEE-f64 arithmetic at C speed with no compile at all (ops/qd.py
    dispatches on the array type).  The callback rides the host
    platform."""

    class _NpTT:
        """Numpy-core view of a TT (qd_gather_tt runs its backend off
        the index array; cores are converted once here, not per call)."""

        def __init__(self, t):
            import numpy as _np

            self.d = t.d
            self.cores = [_np.asarray(c) for c in t.cores]

    def __init__(self, fun_qd, trains):
        self.fun_qd = fun_qd
        self.set_trains(trains)

    def set_trains(self, trains):
        """Swap the subtracted train list IN PLACE.  The engine traces
        only the callback node (self._host is read at call time, not
        trace time), so every defect level reuses ONE compiled engine —
        the level count costs evaluations, not XLA compiles."""
        self.trains = tuple(self._NpTT(t) for t in trains)

    def _host(self, ind):
        import numpy as _np

        from ..ops.qd import qd_gather_tt, qd_sub, qd_to_float

        acc = self.fun_qd(_np.asarray(ind))
        for t in self.trains:
            acc = qd_sub(acc, qd_gather_tt(t, ind))
        return _np.asarray(qd_to_float(acc))

    def __call__(self, ind):
        import jax as _jax
        import jax.numpy as _jnp

        out = _jax.ShapeDtypeStruct(ind.shape[:1], _jnp.float64)
        return _jax.pure_callback(self._host, out, ind,
                                  vmap_method="sequential")


def cross_defect_corrected_qd(
    fun, fun_qd, n, weights_qd,
    max_rank: int = 24, max_rank2: int | None = None,
    levels: int = 3,
    accuracy: float = 1e-13, pivoting: int = 1, key: int = 0,
    verbose: bool = False, mesh=None,
):
    """Multi-level defect-corrected cross quadrature at the QUAD-DOUBLE
    tier (ops/qd.py): the qd extension of cross_defect_corrected.

    With the defect integrand evaluated in qd (~1e-62 relative noise),
    the evaluation floor is no longer the limit — the RANK of the
    correction levels is.  The defect of an f64 train is noise-like (the
    stored cores' f64 rounding is effectively full-rank), so each
    correction cross captures it only up to its rank's share: measured
    on Ising C_4 (d=3, n=33, levels=3), max_rank2=33 (FULL rank) gives
    33.7 digits while max_rank2=30 gives 22.0 — so size max_rank2 at or
    near full rank min(prod(n[:b]), n[b], ...) when >= 30 digits are
    wanted.  Every cross still runs in the fast f64 device engine; only
    the defect integrand and the final per-train contraction
    (ops/qd.qd_contract, ~62-digit accumulation) pay the qd cost.  For
    high precision at ranks far below full, use the true high-precision
    engines instead: cross_dd (~31 digits, device) or cross_mp (120
    digits, host).  fun_qd:
    ind -> QD.  weights_qd: per-mode QD weight vectors.  Returns
    (limbs (4,), info) — limbs are the qd quadrature total.  Full qd
    precision needs a correctly-rounded f64 multiply, so run on the CPU
    platform (same caveat as the dd tier's device path).
    Role match: mptt_dmrgg + mptt_quad, dmrggmp.f90:518-672."""
    from mpmath import mpf, workdps

    from ..ops.qd import qd_contract, qd_from_mp, qd_to_mp

    n = [int(x) for x in n]
    max_rank2 = max_rank2 or max_rank

    trains = []
    nevals, ranks = [], []
    k = key
    defq = _DefectQD(fun_qd, [])
    for lvl in range(levels):
        if lvl == 0:
            f = fun
            r = max_rank
        else:
            defq.set_trains(trains)   # same pinned callable: one compile
            f = defq
            r = max_rank2
        if mesh is not None:
            from ..parallel import cross_parallel

            res = cross_parallel(f, n, max_rank=r, accuracy=accuracy,
                                 pivoting=pivoting, key=k, mesh=mesh,
                                 verbose=verbose)
        else:
            res = cross(f, n, max_rank=r, accuracy=accuracy,
                        pivoting=pivoting, key=k, verbose=verbose)
        trains.append(res.tt)
        nevals.append(res.neval)
        ranks.append(res.ranks)
        k = k + 1 if isinstance(k, int) else k

    import numpy as _np

    with workdps(75):
        qs = []
        total = mpf(0)
        for t in trains:
            q = qd_contract(t, weights_qd)
            limbs = tuple(float(_np.asarray(e)) for e in q)
            qs.append(limbs)
            total += qd_to_mp(*limbs)
        out = qd_from_mp(total)
    info = {
        "nevals": nevals, "ranks": ranks, "qs": qs,
        "levels": levels,
    }
    return out, info
