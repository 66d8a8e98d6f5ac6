"""Alternating-maxvol TT-cross refinement: pivot REPLACEMENT sweeps.

The greedy DMRG-append engine (cross/engine.py, after dtt_dmrgg,
dmrgg.f90:314-760) has a measured fixed-rank quality ceiling: pivots are
appended and never revisited, leaving ~0.5-1 digit on the table versus the
TT-SVD optimum at the same rank (even full pivoting cannot pass it, because the ceiling is the greedy
NESTING of the index sets, not the per-step pivot choice).

This module breaks the ceiling by re-SELECTING whole pivot sets: the
classic alternating maxvol TT-cross iteration (Oseledets & Tyrtyshnikov
2010; the maxvol quasioptimality theory is the 2014 paper the reference
cites at README.md:6-7).  Starting from the greedy cross's index sets
(or a random draw), left-to-right sweeps re-evaluate each bond's fiber
cross A(I_{b-1} x n_b, J_b) and replace the bond's row set I_b by the
rows of the dominant (maximum-volume) r x r submatrix; right-to-left
sweeps do the same for the column sets J_b.  Each exchange step
monotonically grows |det A(I_b, J_b)|, and a (1+tol)-dominant cross is
quasioptimal at its rank.

Device rendering: index sets are static-padded (R, d) multi-index tables,
each bond visit is ONE batched integrand call over the padded fiber
cross (a dense batch), row selection is a masked
partial-pivot LU followed by masked maxvol exchange iterations, and the
whole multi-sweep refinement compiles to one fused device call
(lax.fori_loop over bonds and sweeps).

Evaluation cost: one sweep costs ~ 2 sum_b r_{b-1} n_b r_b integrand
calls (counted like the reference's n_evals, dmrgg.f90:372)."""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["cross_maxvol", "maxvol_refine", "maxvol_select"]


def maxvol_select(M, row_mask, r_act, n_exchange: int = 8,
                  tol: float = 1.01):
    """Select `r_act` rows of M (P, R) whose submatrix has (1+tol)-dominant
    volume: masked partial-pivot elimination for the initial set, then
    masked maxvol exchange iterations (swap in the row argmax|B| while
    max|B| > tol, where B = M inv(M[sel])).

    row_mask (P,) bool marks candidate rows (they may be strided, not a
    prefix); active columns are 0..r_act-1 and padded entries of M must
    already be zero.  Returns (sel (R,) int32 row indices — entries
    >= r_act are meaningless padding — and B (P, R), the interpolation
    coefficients, with B[sel[t]] = e_t on the active block).

    SOLVE-FREE by construction: B is built incrementally during the
    elimination (two outer products per pivot) and each exchange applies
    the Sherman-Morrison rank-1 maxvol update
        B' = B - B[:,t*] (B[i*,:] - e_{t*}) / B[i*,t*]
    — no LU/linalg.solve (a form shaped for the first target,
    whose LU was f32-only)."""
    P, R = M.shape
    rows = jnp.arange(P)
    cols = jnp.arange(R)
    colm = cols < r_act

    # ---- init: partial-pivot elimination, building B alongside.
    # Invariant: res = M - B @ M[sel_t] (residual after t pivots) and
    # B = M @ inv(M[sel_t]) restricted to the chosen columns.
    def lu_step(t, carry):
        res, B, sel, used = carry
        live = t < r_act
        score = jnp.where(row_mask & ~used, jnp.abs(res[:, t]), -1.0)
        rsel = jnp.argmax(score)
        piv = res[rsel, t]
        piv_safe = jnp.where(jnp.abs(piv) > 0, piv, 1.0)
        c = res[:, t] / piv_safe                  # (P,) new coeff column
        res2 = res - jnp.outer(c, res[rsel, :])
        B2 = B - jnp.outer(c, B[rsel, :])         # re-express old columns
        B2 = jnp.where(cols[None, :] == t, c[:, None], B2)
        res = jnp.where(live, res2, res)
        B = jnp.where(live, B2, B)
        sel = sel.at[t].set(jnp.where(live, rsel, 0).astype(jnp.int32))
        used = used | (live & (rows == rsel))
        return res, B, sel, used

    _, B, sel, _ = jax.lax.fori_loop(
        0, R, lu_step,
        (M, jnp.zeros_like(M), jnp.zeros((R,), jnp.int32),
         jnp.zeros((P,), bool)))
    B = jnp.where(row_mask[:, None] & colm[None, :], B, 0.0)

    # ---- maxvol exchange iterations (rank-1 B updates)
    def ex_step(_, carry):
        sel, B, done = carry
        a = jnp.abs(B)
        i_star = jnp.argmax(jnp.max(a, axis=1))
        t_star = jnp.argmax(a[i_star, :])
        improve = (a[i_star, t_star] > tol) & ~done
        denom = B[i_star, t_star]
        denom = jnp.where(jnp.abs(denom) > 0, denom, 1.0)
        u = B[:, t_star]
        v = B[i_star, :] - (cols == t_star)
        B2 = B - jnp.outer(u, v) / denom
        B2 = jnp.where(row_mask[:, None] & colm[None, :], B2, 0.0)
        B = jnp.where(improve, B2, B)
        sel = sel.at[t_star].set(
            jnp.where(improve, i_star.astype(jnp.int32), sel[t_star]))
        return sel, B, done | ~improve

    sel, B, _ = jax.lax.fori_loop(0, n_exchange, ex_step,
                                  (sel, B, jnp.asarray(False)))
    return sel, B


class MaxvolKit(NamedTuple):
    """The refinement run plus its reusable per-bond kernels (the
    distributed engine, parallel/maxvol.py, drives visit_lr / visit_rl
    over bond slabs; all three kernels accept a traced bond id)."""

    run: Callable
    visit_lr: Callable
    visit_rl: Callable
    first_core: Callable
    emit_core: Callable


def masked_solve(S, M, r_act):
    """X = inv(S_act) @ M_act for the active r_act x r_act block of S
    (R, R) applied to M (R, K); padded rows of X are zero.  Partial-pivot
    Gauss-Jordan on the augmented [S | M] — row swaps keep it stable and
    the reduced system [I | X] is row-equivalent to [S | M], so X comes
    out in the original index order.  SOLVE-FREE like maxvol_select."""
    R_, K = S.shape[0], M.shape[1]
    rows = jnp.arange(R_)
    aug = jnp.concatenate([S, M], axis=1)

    def gj_step(t, aug):
        live = t < r_act
        score = jnp.where((rows >= t) & (rows < r_act),
                          jnp.abs(aug[:, t]), -1.0)
        p = jnp.argmax(score)
        rt = aug[t]
        rp = aug[p]
        aug = aug.at[t].set(jnp.where(live, rp, rt))
        aug = aug.at[p].set(jnp.where(live, rt, rp))
        piv = aug[t, t]
        piv = jnp.where(jnp.abs(piv) > 0, piv, 1.0)
        row = aug[t] / piv
        factor = jnp.where((rows != t) & (rows < r_act), aug[:, t], 0.0)
        aug2 = aug - jnp.outer(factor, row)
        aug2 = aug2.at[t].set(row)
        return jnp.where(live, aug2, aug)

    aug = jax.lax.fori_loop(0, R_, gj_step, aug)
    return jnp.where(rows[:, None] < r_act, aug[:, R_:], 0.0)


def _refine_engine(fun: Callable, n: tuple, R: int, n_exchange: int,
                   tol: float) -> "MaxvolKit":
    """Build the jitted multi-sweep refinement run: (LI, RJ, rr,
    n_sweeps) -> (cores, LI, RJ, neval, padded).  LI/RJ (d-1, R, d) are
    the left/right pivot multi-index tables (LI[b, t, :b+1] and
    RJ[b, t, b+1:] valid), rr (d-1,) the per-bond ranks (fixed)."""
    d = len(n)
    N = max(n)
    n_arr = jnp.asarray(n, jnp.int32)
    iR = jnp.arange(R)
    iN = jnp.arange(N)
    col = jnp.arange(d)

    def row_prefixes(LI, b):
        """Candidate left prefixes at bond b: (R*N, d), flat (i, j) =
        i*N + j — LI[b-1] row i extended with mode b = j (at b == 0 the
        prefix is just j)."""
        li = jax.lax.dynamic_index_in_dim(LI, jnp.maximum(b - 1, 0), 0,
                                          keepdims=False)      # (R, d)
        li = jnp.where(b > 0, li, jnp.zeros_like(li))
        pre = jnp.repeat(li, N, axis=0)                        # (R*N, d)
        j = jnp.tile(iN, R)
        return jnp.where(col[None, :] == b, j[:, None], pre).astype(jnp.int32)

    def visit_lr(b, LI, RJ, rr, neval, padded):
        """L->R bond visit: evaluate the fiber cross A(I_{b-1} x n_b, J_b)
        in one batched call and re-select I_b by maxvol.  Returns the
        interpolation core B too (used by the final assembly pass)."""
        pre = row_prefixes(LI, b)                              # (R*N, d)
        rj = jax.lax.dynamic_index_in_dim(RJ, b, 0, keepdims=False)  # (R, d)
        ind = jnp.where(col[None, None, :] <= b, pre[:, None, :],
                        rj[None, :, :])                        # (R*N, R, d)
        vals = fun(ind.reshape(-1, d).astype(jnp.int32)).reshape(R * N, R)
        r_l = jnp.where(b > 0, rr[jnp.maximum(b - 1, 0)], 1)
        rowm = (jnp.repeat(iR, N) < r_l) & (jnp.tile(iN, R) < n_arr[b])
        colm = iR < rr[b]
        M = jnp.where(rowm[:, None] & colm[None, :], vals, 0.0)
        neval = neval + (r_l * n_arr[b] * rr[b]).astype(jnp.int64)
        padded = padded + jnp.asarray(R * N * R, jnp.int64)

        sel, B = maxvol_select(M, rowm, rr[b], n_exchange=n_exchange,
                               tol=tol)
        newI = jnp.take(pre, sel, axis=0)                      # (R, d)
        LI = jax.lax.dynamic_update_slice(LI, newI[None], (b, 0, 0))
        return LI, B.reshape(R, N, R), neval, padded

    def visit_rl(b, LI, RJ, rr, neval, padded):
        """R->L bond visit: evaluate M = A(I_b, n_{b+1} x J_{b+1}) and
        re-select J_b by maxvol on the transpose.

        Also returns core b+1 FOR FREE: maxvol's coefficient matrix is
        B = M^T inv(S_b^T) with S_b = A(I_b, J_b-new), so
        B^T = inv(S_b) A(I_b, n_{b+1} x J_{b+1}) — exactly the (b+1)-th
        core of the standard cross interpolant
        A ~ A(i_0, J_0) prod_b [inv(S_{b-1}) A(I_{b-1}, i_b, J_b)]
        grouped left-associatively.  No assembly pass is needed."""
        li = jax.lax.dynamic_index_in_dim(LI, b, 0, keepdims=False)  # (R, d)
        rj = jax.lax.dynamic_index_in_dim(RJ, jnp.minimum(b + 1, d - 2), 0,
                                          keepdims=False)
        rj = jnp.where(b < d - 2, rj, jnp.zeros_like(rj))
        # suffix candidates, flat (k, q) = k*R + q: mode b+1 = k, rest RJ[b+1][q]
        suf = jnp.repeat(rj[None, :, :], N, axis=0).reshape(N * R, d)
        k = jnp.repeat(iN, R)
        suf = jnp.where(col[None, :] == b + 1, k[:, None], suf).astype(jnp.int32)

        ind = jnp.where(col[None, None, :] <= b, li[:, None, :],
                        suf[None, :, :])                       # (R, N*R, d)
        vals = fun(ind.reshape(-1, d).astype(jnp.int32)).reshape(R, N * R)
        r_r = jnp.where(b < d - 2, rr[jnp.minimum(b + 1, d - 2)], 1)
        colm_k = (jnp.repeat(iN, R) < n_arr[b + 1]) & (jnp.tile(iR, N) < r_r)
        rowm = iR < rr[b]
        M = jnp.where(rowm[:, None] & colm_k[None, :], vals, 0.0)
        neval = neval + (rr[b] * n_arr[b + 1] * r_r).astype(jnp.int64)
        padded = padded + jnp.asarray(R * N * R, jnp.int64)

        sel, B = maxvol_select(M.T, colm_k, rr[b], n_exchange=n_exchange,
                               tol=tol)
        newJ = jnp.take(suf, sel, axis=0)
        RJ = jax.lax.dynamic_update_slice(RJ, newJ[None], (b, 0, 0))
        core = B.T.reshape(R, N, R)           # inv(S_b) M, cols (k, q)
        return RJ, core, neval, padded

    def emit_core(b, LI, RJ, rr, neval, padded):
        """Core b+1 = inv(S_b) A(I_b, n_{b+1} x J_{b+1}) from FROZEN
        index tables: S_b = A(I_b, J_b), both evaluated in one batched
        call, then a masked Gauss-Jordan solve.  Exact for arbitrary
        frozen sets (the CUR-chain identity needs no nestedness), which
        is what the slab-parallel refinement needs — during its sweeps a
        boundary bond's visit_rl reads the neighbour slab's PREVIOUS
        column set, so the free cores visit_rl emits are inconsistent
        across slabs; a final emit_core pass over the merged tables
        restores exactness (parallel/maxvol.py)."""
        li = jax.lax.dynamic_index_in_dim(LI, b, 0, keepdims=False)  # (R, d)
        rj_n = jax.lax.dynamic_index_in_dim(RJ, jnp.minimum(b + 1, d - 2),
                                            0, keepdims=False)
        rj_n = jnp.where(b < d - 2, rj_n, jnp.zeros_like(rj_n))
        suf = jnp.repeat(rj_n[None, :, :], N, axis=0).reshape(N * R, d)
        k = jnp.repeat(iN, R)
        suf = jnp.where(col[None, :] == b + 1, k[:, None],
                        suf).astype(jnp.int32)
        rj_b = jax.lax.dynamic_index_in_dim(RJ, b, 0, keepdims=False)
        cand = jnp.concatenate([suf, rj_b.astype(jnp.int32)], axis=0)
        ind = jnp.where(col[None, None, :] <= b, li[:, None, :],
                        cand[None, :, :])               # (R, N*R + R, d)
        vals = fun(ind.reshape(-1, d).astype(jnp.int32)).reshape(
            R, N * R + R)
        r_r = jnp.where(b < d - 2, rr[jnp.minimum(b + 1, d - 2)], 1)
        rowm = iR < rr[b]
        colm_k = (jnp.repeat(iN, R) < n_arr[b + 1]) & (jnp.tile(iR, N) < r_r)
        M = jnp.where(rowm[:, None] & colm_k[None, :], vals[:, : N * R], 0.0)
        S = jnp.where(rowm[:, None] & rowm[None, :], vals[:, N * R:], 0.0)
        neval = neval + (rr[b] * (n_arr[b + 1] * r_r + rr[b])).astype(jnp.int64)
        padded = padded + jnp.asarray(R * (N * R + R), jnp.int64)
        X = masked_solve(S, M, rr[b])
        return X.reshape(R, N, R), neval, padded

    def first_core(RJ, rr, neval, padded):
        """Core 0 = A(grid_0, J_0) — raw fiber values (N, R)."""
        rj = RJ[0]                                             # (R, d)
        ind = jnp.where(col[None, None, :] == 0,
                        iN[:, None, None], rj[None, :, :])     # (N, R, d)
        vals = fun(ind.reshape(-1, d).astype(jnp.int32)).reshape(N, R)
        m = (iN[:, None] < n_arr[0]) & (iR[None, :] < rr[0])
        neval = neval + (n_arr[0] * rr[0]).astype(jnp.int64)
        padded = padded + jnp.asarray(N * R, jnp.int64)
        return jnp.where(m, vals, 0.0), neval, padded

    @jax.jit
    def run(LI, RJ, rr, n_sweeps):
        neval = jnp.zeros((), jnp.int64)
        padded = jnp.zeros((), jnp.int64)
        cores = jnp.zeros((d, R, N, R))

        def one_sweep(s, carry):
            LI, RJ, cores, neval, padded = carry

            def lr_body(b, c):
                LI, neval, padded = c
                LI, _, neval, padded = visit_lr(b, LI, RJ, rr, neval, padded)
                return LI, neval, padded

            LI, neval, padded = jax.lax.fori_loop(
                0, d - 1, lr_body, (LI, neval, padded))

            def rl_body(u, c):
                RJ, cores, neval, padded = c
                b = d - 2 - u
                RJ, core, neval, padded = visit_rl(b, LI, RJ, rr,
                                                   neval, padded)
                cores = jax.lax.dynamic_update_slice(
                    cores, core[None], (b + 1, 0, 0, 0))
                return RJ, cores, neval, padded

            RJ, cores, neval, padded = jax.lax.fori_loop(
                0, d - 1, rl_body, (RJ, cores, neval, padded))
            return LI, RJ, cores, neval, padded

        LI, RJ, cores, neval, padded = jax.lax.fori_loop(
            0, n_sweeps, one_sweep, (LI, RJ, cores, neval, padded))

        firstc, neval, padded = first_core(RJ, rr, neval, padded)
        cores = jax.lax.dynamic_update_slice(
            cores, firstc[None, :, :][None], (0, 0, 0, 0))
        return cores, LI, RJ, neval, padded

    return MaxvolKit(run=run, visit_lr=visit_lr, visit_rl=visit_rl,
                     first_core=first_core, emit_core=emit_core)


_MV_CACHE: dict = {}
_MV_PINS: list = []

def _get_refine_engine(fun, n, R, n_exchange, tol):
    target = getattr(fun, "__self__", fun)
    ck = (id(target), getattr(fun, "__name__", None), n, R, n_exchange, tol)
    eng = _MV_CACHE.get(ck)
    if eng is None:
        _MV_PINS.append(target)
        eng = _MV_CACHE[ck] = _refine_engine(fun, n, R, n_exchange, tol)
    return eng


def _pad_sets(I, J, d, R):
    """Pad host-side nested index sets (chains.pivot_index_sets layout)
    into the (d-1, R, d) LI / RJ tables + per-bond ranks."""
    LI = np.zeros((d - 1, R, d), np.int32)
    RJ = np.zeros((d - 1, R, d), np.int32)
    rr = np.zeros((d - 1,), np.int32)
    for b in range(d - 1):
        rr[b] = len(I[b])
        for t, pre in enumerate(I[b]):
            LI[b, t, : b + 1] = pre
        for t, suf in enumerate(J[b]):
            RJ[b, t, b + 1:] = suf
    return LI, RJ, rr


def _rank_vector(ranks, n):
    """Per-bond ranks from a scalar or sequence, capped by the unfolding
    dimensions min(prod n[:b+1], prod n[b+1:])."""
    d = len(n)
    if np.isscalar(ranks):
        lcap = np.minimum(np.cumprod(np.asarray(n[:-1], np.float64)), 1e18)
        rcap = np.minimum(np.cumprod(np.asarray(n[:0:-1], np.float64))[::-1],
                          1e18)
        return np.minimum(float(ranks),
                          np.minimum(lcap, rcap)).astype(np.int32)
    rr = np.asarray(ranks, np.int32)
    if rr.shape != (d - 1,):
        raise ValueError(f"ranks must be scalar or length d-1, got {rr.shape}")
    return rr


def _seed_from_key(key) -> int:
    """Integer seed for numpy's Generator from either an int or a jax
    PRNGKey (both key flavours the cross() API accepts) — a non-int key
    must vary the draw, not silently collapse to seed 0."""
    if isinstance(key, (int, np.integer)):
        return int(key)
    k = jnp.asarray(key)
    if jnp.issubdtype(k.dtype, jax.dtypes.prng_key):
        k = jax.random.key_data(k)
    return int(np.asarray(k).ravel()[-1])


def _prepare_refine_sets(init_sets, ranks, n, d: int, max_rank, key):
    """Shared maxvol_refine / maxvol_refine_parallel input prep: padded
    (LI, RJ) index tables + rank vector from either explicit pivot sets
    or a seeded random column-set draw (classic TT-cross init)."""
    if init_sets is not None:
        I, J = init_sets
        rr_probe = max(len(I[b]) for b in range(d - 1))
        R = int(max_rank if max_rank is not None else rr_probe)
        LI, RJ, rr = _pad_sets(I, J, d, R)
    else:
        if ranks is None:
            raise ValueError("ranks is required without init_sets")
        rr = _rank_vector(ranks, n)
        R = int(max_rank if max_rank is not None else rr.max())
        rng = np.random.default_rng(_seed_from_key(key))
        LI = np.zeros((d - 1, R, d), np.int32)
        RJ = np.zeros((d - 1, R, d), np.int32)
        for b in range(d - 1):
            for c in range(b + 1, d):
                RJ[b, :, c] = rng.integers(0, n[c], size=R)
    if np.any(rr > R):
        raise ValueError(f"ranks {rr.max()} exceed the padding R={R}")
    return LI, RJ, rr, R


def maxvol_refine(fun, n: Sequence[int], ranks=None, init_sets=None,
                  sweeps: int = 2, quad=None, truth=None, key=0,
                  n_exchange: int = 8, tol: float = 1.01,
                  max_rank: int | None = None):
    """Refine (or build from scratch) a TT-cross of `fun` at fixed
    per-bond `ranks` by alternating maxvol sweeps.

    init_sets: (I, J) nested pivot index sets in chains.pivot_index_sets
    layout — e.g. a greedy cross's pivots (cross(..., refine_sweeps=k)
    wires this automatically); ranks are then taken from the sets.  When
    None, the column sets start from a random draw (classic TT-cross
    init) and `ranks` is required.  Returns a CrossResult whose tt is the
    refined interpolant; padded_evals counts the full padded batches."""
    from ..tt.types import TT
    from .engine import CrossResult

    n = tuple(int(x) for x in n)
    d = len(n)
    if d < 2:
        raise ValueError("maxvol_refine requires d >= 2")
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1 (the cores are emitted "
                         "during the last R->L half sweep)")
    t0 = time.perf_counter()

    LI, RJ, rr, R = _prepare_refine_sets(init_sets, ranks, n, d, max_rank,
                                         key)

    run = _get_refine_engine(fun, n, R, n_exchange, tol).run
    args = (jnp.asarray(LI), jnp.asarray(RJ), jnp.asarray(rr),
            jnp.asarray(int(sweeps), jnp.int32))
    cores, LI2, RJ2, neval, padded = run(*args)
    rk = np.concatenate([[1], np.asarray(rr), [1]])
    tt = TT(tuple(cores[c, : rk[c], : n[c], : rk[c + 1]] for c in range(d)))

    values, errors = [], []
    if quad is not None:
        from ..tt.ops import contract

        val = float(contract(tt, list(quad)))
        values.append(val)
        if truth is not None:
            errors.append(abs(1.0 - val / truth))
    return CrossResult(
        tt=tt, neval=int(neval), sweeps=int(sweeps),
        ranks=tuple(int(x) for x in rk), values=values, errors=errors,
        time=time.perf_counter() - t0, converged=True,
        history=None, padded_evals=int(padded),
    )


def cross_maxvol(fun, n: Sequence[int], max_rank: int = 20,
                 sweeps: int = 3, **kw):
    """Classic alternating-maxvol TT-cross from random init — the second
    cross algorithm next to the greedy DMRG engine (engine.py)."""
    return maxvol_refine(fun, n, ranks=max_rank, init_sets=None,
                         sweeps=sweeps, **kw)
