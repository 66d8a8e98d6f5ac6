"""Single-process DMRG-greedy TT-cross engine, jit-compiled per sweep.

Accelerator re-architecture of dtt_dmrgg (dmrgg.f90:11-1050).  Structure of a
sweep (one rank increment per bond, alternating direction, dmrgg.f90:314-323)
is preserved exactly — the greedy pivot acceptance rule, the two-threshold
test, the rook/lottery/full pivot hunts, and the strike-based stopping —
but every mechanism is rebuilt for XLA:

  * dynamic rank growth  -> static padding + active-rank masks (state.py)
  * OMP scalar fun loops -> batched integrand fun(ind[B, d]) -> (B,)
  * vip chain walks      -> per-bond scanned index tables (chains.py)
  * idamax chains        -> masked argmax over scored candidate batches
  * incremental LU dgemv -> masked borders + batched triangular solves (ops/lu.py)
  * per-iteration quad   -> contracted (R, R) chain with LU solves, one einsum
                            per core (dmrgg.f90:975-1006)

The per-sweep function compiles once; the Python driver loop only handles
progress printing and the stopping rule, mirroring the reference's per-
iteration report (dmrgg.f90:969-1019).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace as dc_replace
from typing import Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import precision_thresholds
from ..ops import lu as lulib
from ..tt.types import TT
from .chains import (advance_left, advance_right, all_left_tables,
                     all_right_tables, assemble_indices, left_table, right_table)
from .state import CrossState, empty_state

# f32 contractions state their precision: on GPUs XLA may otherwise run
# them in TF32 (~11 significant bits), which would round lottery weights
# and residual scores
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["CrossResult", "cross", "make_engine"]


@dataclass(frozen=True)
class CrossConfig:
    d: int
    n: tuple[int, ...]   # per-mode sizes
    N: int               # padded mode size = max(n)
    R: int               # padded rank = maxrank
    piv: int             # -1 full, 0 lottery, >=1 rook searches
    small_element: float
    small_pivot: float
    snum: int = 8        # shifted diagonals in the initial search (smin, dmrgg.f90:29)
    wlot: bool = False   # weight the lottery by the quadrature weights
                         # (lottery2's arbitrary-weights path, rnd.f90:105-126)
    jacobi: bool = False  # all-bonds-batched Jacobi sweeps (sweep_mode="jacobi")
    rb: bool = False     # red-black two-phase variant (sweep_mode=
                         # "jacobi-rb"): even bonds accept, then odd bonds
                         # against fresh factors — sequential-grade
                         # neighbor coupling at batched-call cost
    caps: tuple | None = None  # per-bond rank caps (cross(rank_caps=...)):
                         # integrand batches shrink to the capped per-bond
                         # fiber sizes, closing the padded-work gap that a
                         # single global padded rank leaves on rank-
                         # heterogeneous trains
    adaptive: float = 0.0  # adaptive hunt gating margin (cross(adaptive=)):
                         # >0 skips a bond's rook fiber evaluations when the
                         # lottery's best residual, amplified by this
                         # margin, still fails EITHER acceptance threshold
                         # (acceptance needs both) or the bond is rank-
                         # saturated — a
                         # converged bond then costs ~2(R+N) lottery evals
                         # instead of ~2*piv*R*N per sweep.  0 = off (the
                         # reference evaluates every bond every sweep)


class EngineKit(NamedTuple):
    """Compiled engine phases plus the reusable per-bond kernels the
    distributed engine (parallel/engine.py) builds on."""

    cfg: "CrossConfig"
    init_fn: Callable
    sweep_fn: Callable
    value_fn: Callable
    make_run_fn: Callable
    visit_bond: Callable
    value_mat: Callable
    eval_col_fiber: Callable
    eval_row_fiber: Callable
    init_neval: int
    finalize_fn: Callable = None
    make_full_fn: Callable = None
    jacobi_hunt: Callable = None
    jacobi_apply: Callable = None
    value_mats: Callable = None     # all-d batched value_mat (d, R, R)


@dataclass
class CrossResult:
    tt: TT                    # may be constructed with a zero-arg thunk:
                              # resolved (and cached) on first access, so
                              # flows that never touch the train skip its
                              # device->host materialization entirely
    neval: int
    sweeps: int
    ranks: tuple[int, ...]
    values: list
    errors: list
    time: float
    converged: bool
    history: list | None = None   # structured SweepRecords (utils/metrics.py)
    state: object | None = None   # final CrossState when return_state=True
    padded_evals: int | None = None  # ACTUAL integrand calls incl. padding

    def __getattribute__(self, name):
        if name == "tt":
            v = object.__getattribute__(self, "tt")
            if callable(v) and not isinstance(v, TT):
                v = v()
                object.__setattr__(self, "tt", v)
            return v
        return object.__getattribute__(self, name)


def auto_chunks(max_rank: int, n_chunks: int = 4) -> list[int]:
    """Default rank-chunk schedule: evenly spaced padding levels ending at
    max_rank.  With k chunks the padded fiber work is ~(k+1)/(2k) * R^2
    versus the reference's exact ~R^2/2 — 1.25x at k=4."""
    if max_rank <= 6:
        return [max_rank]
    nch = n_chunks if max_rank >= 4 * n_chunks else 2
    ch = sorted({max(4, -(-max_rank * k // nch)) for k in range(1, nch + 1)})
    return [c for c in ch if c <= max_rank] if ch[-1] == max_rank else ch + [max_rank]


def round_and_revalue(res: "CrossResult", max_rank: int, quad, truth):
    """Shared oversample post-pass (cross() / cross_parallel()): TT-SVD-
    truncate the oversampled train to max_rank and append the rounded
    train's quadrature value + error to the history (nan when the previous
    value is 0, matching _values_errors).

    Telemetry stays consistent with the returned train: the revaluation is
    appended as its own SweepRecord (direction 'rd', n_evals unchanged —
    rounding evaluates nothing), so values/errors/history all have one
    trailing post-round entry describing the truncated train."""
    from ..tt.ops import contract
    from ..tt.ortho import svd_round
    from ..utils.metrics import SweepRecord

    res.tt = svd_round(res.tt, tol=0.0, rmax=max_rank)
    res.ranks = tuple(int(x) for x in res.tt.r)
    if quad is not None:
        val = float(contract(res.tt, list(quad)))
        res.values.append(val)
        if truth is not None:
            res.errors.append(abs(1.0 - val / truth))
        else:
            prev = res.values[-2]
            res.errors.append(abs(1.0 - val / prev) if prev != 0 else float("nan"))
        if res.history is not None:
            res.history.append(SweepRecord(
                it=res.sweeps + 1, direction="rd", n_evals=res.neval,
                pivotmax=float(res.history[-1].pivotmax) if res.history else 0.0,
                value=val,
                err=res.errors[-1] if truth is not None else None,
                cnv=None if truth is not None else res.errors[-1]))
    return res


def _apply_host_reeval(res: "CrossResult", fun_np, n, rmax, quad, truth):
    """Host re-evaluation post-pass (cross(host_reeval=fun_np)): rebuild
    the train from HOST-evaluated data at the frozen pivot skeleton,
    optionally TT-SVD-round to rmax, and re-value — all in host
    arithmetic.  The accuracy half of the refine-tier split for the f64
    tier, built for a platform whose device f64 was emulated: the device
    picks the pivots and the host supplies the data.  fun_np:
    ``fun_np(ind (B, d) int numpy) -> (B,) f64 numpy``.  neval /
    padded_evals grow by the skeleton re-samples (real integrand
    calls); the revaluation appends a direction-'hr' history record."""
    from ..tt.ortho import svd_round_host
    from ..utils.metrics import SweepRecord
    from .skeleton import extract_skeleton, reevaluate_host

    skel = extract_skeleton(res, n)
    cores = reevaluate_host(fun_np, skel)
    if rmax is not None:
        cores = svd_round_host(cores, tol=0.0, rmax=rmax)
    res.tt = TT(tuple(jnp.asarray(c) for c in cores))
    res.ranks = tuple(int(x) for x in res.tt.r)
    res.neval += skel.n_samples
    if res.padded_evals is not None:
        res.padded_evals += skel.n_samples
    if quad is not None:
        v = np.ones((1, 1))
        for c, g in enumerate(cores):
            v = v @ np.einsum("inj,n->ij", g, np.asarray(quad[c], np.float64))
        val = float(v[0, 0])
        res.values.append(val)
        if truth is not None:
            res.errors.append(abs(1.0 - val / truth))
        else:
            prev = res.values[-2]
            res.errors.append(abs(1.0 - val / prev) if prev != 0 else float("nan"))
        if res.history is not None:
            res.history.append(SweepRecord(
                it=res.sweeps + 1, direction="hr", n_evals=res.neval,
                pivotmax=float(res.history[-1].pivotmax) if res.history else 0.0,
                value=val,
                err=res.errors[-1] if truth is not None else None,
                cnv=None if truth is not None else res.errors[-1]))
    return res


def _values_errors(vals, last_it: int, truth, with_quad: bool):
    """values list + per-sweep rel errors (err vs truth, or cnv vs the
    previous sweep) from the packed per-sweep value array."""
    values, errors = [], []
    if with_quad:
        values = list(vals[: last_it + 1])
        for i in range(1, last_it + 1):
            if truth is not None:
                errors.append(abs(1.0 - vals[i] / truth))
            else:
                prev = vals[i - 1]
                errors.append(abs(1.0 - vals[i] / prev) if prev != 0 else float("nan"))
    return values, errors


def _lu_at(st: CrossState, b) -> lulib.GrowingLU:
    return lulib.GrowingLU(
        c=jax.lax.dynamic_index_in_dim(st.lu_c, b, 0, keepdims=False),
        u=jax.lax.dynamic_index_in_dim(st.lu_u, b, 0, keepdims=False),
        d=jax.lax.dynamic_index_in_dim(st.lu_d, b, 0, keepdims=False),
    )


def _at(arr, c):
    return jax.lax.dynamic_index_in_dim(arr, c, 0, keepdims=False)


_ENGINE_CACHE: dict = {}
_ENGINE_PINS: list = []  # keep integrand objects alive so id() keys stay valid


def get_engine(fun: Callable, cfg: CrossConfig, chain=None):
    """Memoized make_engine: repeated cross() calls with the same integrand
    and config reuse the compiled XLA executables (compilation is
    expensive; tracing fresh jitted closures per call would recompile
    every time).  Bound methods are keyed by their bound object so
    `prob.fun` hits the cache across accesses."""
    target = getattr(fun, "__self__", fun)
    key = (id(target), getattr(fun, "__name__", None), cfg,
           None if chain is None else id(chain))
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        _ENGINE_PINS.append(target)
        if chain is not None:
            _ENGINE_PINS.append(chain)
        eng = _ENGINE_CACHE[key] = make_engine(fun, cfg, chain=chain)
    return eng


def make_engine(fun: Callable, cfg: CrossConfig, chain=None):
    """Build the jitted phases: (init_fn, sweep_fn, value_fn).

    fun: batched integrand ind(B, d) int32 -> (B,) values.
    chain: optional chain_eval.ChainSpec — O(1) interface-state hunt
    evaluation for chain-structured integrands (jacobi sweep family)."""
    d, N, R = cfg.d, cfg.N, cfg.R
    n_arr = jnp.asarray(cfg.n, dtype=jnp.int32)
    NLOT = 2 * (R + N)
    iR = jnp.arange(R)
    iN = jnp.arange(N)

    # ---------------------------------------------------------------- init
    @jax.jit
    def init_fn(key) -> CrossState:
        """Initial pivot search over shifted diagonals + rank-1 cross
        (dmrgg.f90:151-248)."""
        st = empty_state(d, N, R, key)
        nn = int(min(cfg.n))
        # candidates ind[k + s*nn, p] = (k + s*p) mod n_p
        ks = jnp.arange(nn)[None, :, None]            # (1, nn, 1)
        ss = jnp.arange(cfg.snum)[:, None, None]      # (snum, 1, 1)
        ps = jnp.arange(d)[None, None, :]             # (1, 1, d)
        cand = jnp.reshape((ks + ss * ps) % n_arr[None, None, :], (-1, d)).astype(jnp.int32)
        vals = fun(cand)
        best = jnp.argmax(jnp.abs(vals))
        amax = jnp.abs(vals[best])
        ind0 = cand[best]                              # (d,)

        # initial vip: (0, ind0[b], ind0[b+1], 0) per bond
        vip = st.vip.at[:, 0, 1].set(ind0[:-1]).at[:, 0, 2].set(ind0[1:])

        # rank-1 fibers: for each core c vary mode c over its grid
        fib_ind = jnp.broadcast_to(ind0, (d, N, d)).reshape(-1, d)
        mode_pos = jnp.repeat(jnp.arange(d), N)
        mode_val = jnp.tile(iN, d)
        col = jnp.arange(d)
        fib_ind = jnp.where(col[None, :] == mode_pos[:, None],
                            jnp.minimum(mode_val, n_arr[mode_pos] - 1)[:, None], fib_ind)
        fvals = fun(fib_ind.astype(jnp.int32)).reshape(d, N)
        fmask = iN[None, :] < n_arr[:, None]
        fvals = jnp.where(fmask, fvals, 0.0)
        amax = jnp.maximum(amax, jnp.max(jnp.abs(fvals)))

        cores = st.cores.at[:, 0, :, 0].set(fvals)
        delta = fvals[0, ind0[0]]                      # = A(ind0), same for all fibers
        lu_d = st.lu_d.at[:, 0].set(delta)
        itt = st.itt.at[:, 0, 0].set(1.0 / delta)      # T = diag(delta, 1, ...)
        colf = st.colf.at[:, 0, :, 0].set(fvals / delta)  # d2_lual at r=1 divides by pivot
        rowf = st.rowf.at[:, 0, :, 0].set(fvals)          # d2_luar at r=1 is a no-op
        neval = jnp.asarray(cfg.snum * nn + int(sum(cfg.n)), jnp.int64)
        padded = jnp.asarray(cfg.snum * nn + d * N, jnp.int64)
        return st._replace(cores=cores, colf=colf, rowf=rowf, vip=vip, lu_d=lu_d,
                           itt=itt, amax=amax, pivotmax_prev=amax, neval=neval,
                           key=key, padded=padded)

    # ----------------------------------------------------------- bond visit
    def _eval_col_fiber(st, p, ltab, rtab, kk, qq):
        """Raw column fiber acol(R, N) at fixed (kk, qq), masked to the
        active (rk[p], n_p) block; returns (acol, amax', neval')."""
        i_g = jnp.repeat(iR, N)
        j_g = jnp.tile(iN, R)
        ind = assemble_indices(ltab, rtab, p, i_g, j_g,
                               jnp.full_like(i_g, kk), jnp.full_like(i_g, qq), d)
        vals = fun(ind).reshape(R, N)
        mask = (iR[:, None] < st.rk[p]) & (iN[None, :] < n_arr[p])
        vals = jnp.where(mask, vals, 0.0)
        amax = jnp.maximum(st.amax, jnp.max(jnp.abs(vals)))
        neval = st.neval + (st.rk[p] * n_arr[p]).astype(jnp.int64)
        return vals, amax, neval, st.padded + R * N

    def _eval_row_fiber(st, p, ltab, rtab, ii, jj):
        """Raw row fiber arow(N, R) at fixed (ii, jj), masked to (n_{p+1},
        rk[p+2])."""
        k_g = jnp.repeat(iN, R)
        q_g = jnp.tile(iR, N)
        ind = assemble_indices(ltab, rtab, p, jnp.full_like(k_g, ii),
                               jnp.full_like(k_g, jj), k_g, q_g, d)
        vals = fun(ind).reshape(N, R)
        mask = (iN[:, None] < n_arr[p + 1]) & (iR[None, :] < st.rk[p + 2])
        vals = jnp.where(mask, vals, 0.0)
        amax = jnp.maximum(st.amax, jnp.max(jnp.abs(vals)))
        neval = st.neval + (n_arr[p + 1] * st.rk[p + 2]).astype(jnp.int64)
        return vals, amax, neval, st.padded + N * R

    def _col_residual(st, p, acol, kk, qq):
        """bcol = acol - colf[p] @ rowf[p+1][:, kk, qq]  (dmrgg.f90:537-539)."""
        rmask = (iR < st.rk[p + 1]).astype(acol.dtype)
        u = _at(st.rowf, p + 1)[:, kk, qq] * rmask        # (R,)
        approx = jnp.tensordot(_at(st.colf, p), u, axes=[[2], [0]])  # (R, N)
        return acol - approx

    def _row_residual(st, p, arow, ii, jj):
        """brow = arow - colf[p][ii, jj, :] @ rowf[p+1]  (dmrgg.f90:570-572)."""
        rmask = (iR < st.rk[p + 1]).astype(arow.dtype)
        c = _at(st.colf, p)[ii, jj, :] * rmask            # (R,)
        approx = jnp.tensordot(c, _at(st.rowf, p + 1), axes=[[0], [0]])  # (N, R)
        return arow - approx

    def _masked_argmax2(x, mask):
        # two-stage argmax instead of flat argmax + divmod decode (a form
        # shaped for the first target, where integer division was bit-serial)
        score = jnp.where(mask, jnp.abs(x), -1.0)
        i = jnp.argmax(jnp.max(score, axis=1))
        j = jnp.argmax(jax.lax.dynamic_index_in_dim(score, i, 0, keepdims=False))
        return i, j

    def _decode_div(lin, den: int):
        """(lin // den, lin % den) for 0 <= lin < 2^20 without integer
        division (shaped for the first target): exact f64 floor with a +1/2
        offset to clear representation error at exact multiples."""
        q = jnp.floor((lin.astype(jnp.float64) + 0.5) * (1.0 / den)).astype(lin.dtype)
        return q, lin - q * den

    def _hunt_lottery(st: CrossState, p, ltab, rtab, u2, lw=None):
        """Weighted lottery over candidate rows/cols (lottery2, rnd.f90:105-126;
        dmrgg.f90:410-487), residual scoring, seed pivot.

        u2 (2, NLOT) f64 in [0,1): pre-drawn uniforms (one PRNG call per
        sweep rather than a per-visit randint with a traced bound).
        Inverse-CDF
        draw over the allowed set, exactly lottery2's real-valued scheme
        (find_d, rnd.f90:128-144).

        lw (d, N): optional per-mode lottery weights (cfg.wlot) — candidate
        (i, j) draws with probability ~ lw[p, j], rows with ~ lw[p+1, k],
        exercising lottery2's arbitrary-weights path."""
        dt = st.cores.dtype

        # layouts: columns (i, j) flattened i*N + j; rows (q, k) flattened q*N + k
        colmask = ((iR[:, None] < st.rk[p]) & (iN[None, :] < n_arr[p])).reshape(-1)
        rowmask = ((iR[:, None] < st.rk[p + 2]) & (iN[None, :] < n_arr[p + 1])).reshape(-1)
        # zero weight on already-used pivots (dmrgg.f90:432-439)
        vb = _at(st.vip, p)                       # (R, 4)
        smask = iR < st.rk[p + 1]
        used_col = jnp.zeros((R * N,), bool).at[vb[:, 0] * N + vb[:, 1]].max(smask)
        used_row = jnp.zeros((N * R,), bool).at[vb[:, 3] * N + vb[:, 2]].max(smask)
        f32 = jnp.float32
        wcol = (colmask & ~used_col).astype(f32)
        wrow = (rowmask & ~used_row).astype(f32)
        if cfg.wlot and lw is not None:
            wcol = wcol * jnp.tile(jnp.abs(_at(lw, p)), R).astype(f32)
            wrow = wrow * jnp.tile(jnp.abs(_at(lw, p + 1)), R).astype(f32)
        # draw over the allowed sets via inverse CDF; with unit weights
        # (the reference's default 0/1 lottery, dmrgg.f90:424-439) this is
        # a uniform draw without the ~R*N f64 Gumbel transcendentals per
        # candidate.  The CDF is an f32 triangular-ones matmul (shaped
        # for the first target, whose cumsum was a serial loop); sampling needs no f64
        # (f32 sums are exact for the 0/1 masks up to 2^24).
        tri = jnp.triu(jnp.ones((R * N, R * N), f32))   # [j <= i]
        cdf_c = jnp.dot(wcol, tri, precision=_HIGHEST)
        cdf_r = jnp.dot(wrow, tri, precision=_HIGHEST)
        # clamp t strictly below cdf[-1]: u ~ 1 can round t up to exactly
        # cdf[-1], where side='right' would step past the LAST ALLOWED
        # candidate into the masked padding region ((1 - 2^-20) multiply
        # instead of nextafter).
        below = f32(1.0 - 2.0 ** -20)
        t_c = jnp.minimum(u2[0].astype(f32)
                          * jnp.where(cdf_c[-1] > 0, cdf_c[-1], 1.0),
                          cdf_c[-1] * below)
        t_r = jnp.minimum(u2[1].astype(f32)
                          * jnp.where(cdf_r[-1] > 0, cdf_r[-1], 1.0),
                          cdf_r[-1] * below)
        # method="compare_all": one broadcast compare + row-sum instead of
        # the default 'scan' binary search (log2(R*N) serial gather rounds
        # per query batch)
        lin_c = jnp.minimum(
            jnp.searchsorted(cdf_c, t_c, side="right", method="compare_all"),
            R * N - 1).astype(jnp.int_)
        lin_r = jnp.minimum(
            jnp.searchsorted(cdf_r, t_r, side="right", method="compare_all"),
            N * R - 1).astype(jnp.int_)
        i_c, j_c = _decode_div(lin_c, N)
        q_c, k_c = _decode_div(lin_r, N)

        nlot_act = st.rk[p] + n_arr[p] + n_arr[p + 1] + st.rk[p + 2]
        candmask = jnp.arange(NLOT) < nlot_act

        ind = assemble_indices(ltab, rtab, p, i_c, j_c, k_c, q_c, d)
        b = fun(ind)
        amax = jnp.maximum(st.amax, jnp.max(jnp.where(candmask, jnp.abs(b), 0.0)))
        neval = st.neval + nlot_act.astype(jnp.int64)

        # residual b - colf[p][i,j,:] . rowf[p+1][:,k,q]  (dmrgg.f90:469-476)
        # with the factor rows gathered in one batch
        from ..ops.dense import row_lookup

        rmask = (iR < st.rk[p + 1]).astype(dt)
        cf = row_lookup(_at(st.colf, p).reshape(R * N, R), lin_c)      # (NLOT, R)
        rf = row_lookup(_at(st.rowf, p + 1).reshape(R, N * R),
                        k_c * R + q_c, axis=1)                         # (NLOT, R)
        resid = b - jnp.sum(cf * rf * rmask[None, :], axis=1)
        best = jnp.argmax(jnp.where(candmask, jnp.abs(resid), -1.0))
        st = st._replace(amax=amax, neval=neval, padded=st.padded + NLOT)
        return st, (i_c[best], j_c[best], k_c[best], q_c[best]), resid[best]

    def _rook(st: CrossState, p, ltab, rtab, seed, pivot0, fwd: bool):
        """Rook pivoting (dmrgg.f90:515-582): alternate column/row
        maximization until stationary or crs >= 2 piv.

        The reference's `do while` is UNROLLED into exactly 2*piv
        straight-line masked passes: for a fixed budget the dynamic loop
        executes exactly 2*piv passes unless it goes stationary early, and
        a while_loop + nested-cond version pays per-iteration overhead
        that dwarfs the (tiny) pass math.  The sweep direction is
        a TRACE-TIME constant (the sweep dispatch conds once per sweep on
        the parity), so '>>' sweeps run col,row,col,... and '<<' sweeps
        row,col,row,... (skipcol, dmrgg.f90:517) with each pass assembling
        and scoring ONLY its own side — an earlier rendering carried a
        traced direction and paid both sides' index assembly, residual and
        argmax in every pass.  A pass whose `done` flag is set contributes
        nothing: state and n_evals are frozen by masking, so results and
        evaluation counts match the dynamic loop."""
        ii0, jj0, kk0, qq0 = seed
        dt = st.cores.dtype
        false = jnp.asarray(False)
        # carry: ii jj kk qq pivot acol arow havecol haverow crs done amax neval
        c = dict(ii=ii0, jj=jj0, kk=kk0, qq=qq0, pivot=pivot0,
                 acol=jnp.zeros((R, N), dt), arow=jnp.zeros((N, R), dt),
                 havecol=false, haverow=false,
                 crs=jnp.asarray(0, jnp.int32), done=false,
                 amax=st.amax, neval=st.neval)

        def sel(live, new, old):
            return jax.tree_util.tree_map(
                lambda a, b: jnp.where(live, a, b), new, old)

        # candidate enumerations: col fibers vary (i, j) over (R, N) at the
        # carry's fixed (kk, qq); row fibers vary (k, q) over (N, R) at the
        # fixed (ii, jj)
        ci_g, cj_g = jnp.repeat(iR, N), jnp.tile(iN, R)
        rk_g, rq_g = jnp.repeat(iN, R), jnp.tile(iR, N)
        cmask = (iR[:, None] < st.rk[p]) & (iN[None, :] < n_arr[p])
        rmask2 = (iN[:, None] < n_arr[p + 1]) & (iR[None, :] < st.rk[p + 2])

        def unified_pass(c, is_col: bool):
            live = ~c["done"]
            crs = c["crs"] + 1
            if is_col:
                ind = assemble_indices(ltab, rtab, p, ci_g, cj_g,
                                       jnp.full_like(ci_g, c["kk"]),
                                       jnp.full_like(ci_g, c["qq"]), d)
                acol = jnp.where(cmask, fun(ind).reshape(R, N), 0.0)
                amax = jnp.maximum(c["amax"], jnp.max(jnp.abs(acol)))
                dnev = (st.rk[p] * n_arr[p]).astype(jnp.int64)
                bcol = _col_residual(st, p, acol, c["kk"], c["qq"])
                i2, j2 = _masked_argmax2(bcol, cmask)
                havecol, haverow = jnp.asarray(True), c["haverow"]
                budget = haverow & (crs >= 2 * cfg.piv)
                stat = haverow & (i2 == c["ii"]) & (j2 == c["jj"])
                upd = ~budget
                new = dict(ii=jnp.where(upd, i2, c["ii"]),
                           jj=jnp.where(upd, j2, c["jj"]),
                           kk=c["kk"], qq=c["qq"],
                           pivot=jnp.where(upd, bcol[i2, j2], c["pivot"]),
                           acol=acol, arow=c["arow"])
            else:
                ind = assemble_indices(ltab, rtab, p,
                                       jnp.full_like(rk_g, c["ii"]),
                                       jnp.full_like(rk_g, c["jj"]),
                                       rk_g, rq_g, d)
                arow = jnp.where(rmask2, fun(ind).reshape(N, R), 0.0)
                amax = jnp.maximum(c["amax"], jnp.max(jnp.abs(arow)))
                dnev = (n_arr[p + 1] * st.rk[p + 2]).astype(jnp.int64)
                brow = _row_residual(st, p, arow, c["ii"], c["jj"])
                k2, q2 = _masked_argmax2(brow, rmask2)
                havecol, haverow = c["havecol"], jnp.asarray(True)
                budget = havecol & (crs >= 2 * cfg.piv)
                stat = havecol & (k2 == c["kk"]) & (q2 == c["qq"])
                upd = ~budget
                new = dict(ii=c["ii"], jj=c["jj"],
                           kk=jnp.where(upd, k2, c["kk"]),
                           qq=jnp.where(upd, q2, c["qq"]),
                           pivot=jnp.where(upd, brow[k2, q2], c["pivot"]),
                           acol=c["acol"], arow=arow)
            new.update(havecol=havecol, haverow=haverow, crs=crs,
                       done=budget | (upd & stat),
                       amax=amax, neval=c["neval"] + dnev)
            return sel(live, new, c)

        for t in range(2 * cfg.piv):
            # '>>': col on even passes; '<<': row first
            c = unified_pass(c, fwd == (t % 2 == 0))
        # padded work: every unrolled pass calls fun on a full (R, N)
        # batch whether or not its `done` flag froze the state
        st = st._replace(amax=c["amax"], neval=c["neval"],
                         padded=st.padded + 2 * cfg.piv * R * N)
        return st, (c["ii"], c["jj"], c["kk"], c["qq"]), c["pivot"], c["acol"], c["arow"]

    def _hunt_piv0(st, p, ltab, rtab, seed, pivot0):
        """piv = 0: evaluate the seed's full column and row once
        (dmrgg.f90:492-513)."""
        ii, jj, kk, qq = seed
        acol, amax, neval, padded = _eval_col_fiber(st._replace(), p, ltab, rtab, kk, qq)
        st = st._replace(amax=amax, neval=neval, padded=padded)
        arow, amax, neval, padded = _eval_row_fiber(st, p, ltab, rtab, ii, jj)
        st = st._replace(amax=amax, neval=neval, padded=padded)
        return st, seed, pivot0, acol, arow

    def _hunt_full(st: CrossState, p, ltab, rtab):
        """piv = -1: full superblock residual pivoting (dmrgg.f90:341-408)."""
        dt = st.cores.dtype
        # enumerate (i, j, k, q) over (R, N, N, R) in row-major layout
        gr = jnp.arange(R * N * N * R)
        qg = gr % R
        kg = (gr // R) % N
        jg = (gr // (R * N)) % N
        ig = gr // (R * N * N)
        ind = assemble_indices(ltab, rtab, p, ig, jg, kg, qg, d)
        vals = fun(ind).reshape(R, N, N, R)
        mask = ((iR[:, None, None, None] < st.rk[p]) & (iN[None, :, None, None] < n_arr[p])
                & (iN[None, None, :, None] < n_arr[p + 1]) & (iR[None, None, None, :] < st.rk[p + 2]))
        vals = jnp.where(mask, vals, 0.0)
        amax = jnp.maximum(st.amax, jnp.max(jnp.abs(vals)))
        neval = st.neval + (st.rk[p] * n_arr[p] * n_arr[p + 1] * st.rk[p + 2]).astype(jnp.int64)
        st = st._replace(amax=amax, neval=neval, padded=st.padded + R * N * N * R)

        rmask = (iR < st.rk[p + 1]).astype(dt)
        colf_m = _at(st.colf, p) * rmask[None, None, :]
        rowf_m = _at(st.rowf, p + 1)
        approx = jnp.einsum("ijr,rkq->ijkq", colf_m, rowf_m)
        resid = jnp.where(mask, vals - approx, 0.0)
        flat = jnp.argmax(jnp.abs(resid).reshape(-1))
        qq = flat % R
        kk = (flat // R) % N
        jj = (flat // (R * N)) % N
        ii = flat // (R * N * N)
        pivot = resid[ii, jj, kk, qq]
        acol = vals[:, :, kk, qq]
        arow = vals[ii, jj, :, :]
        return st, (ii, jj, kk, qq), pivot, acol, arow

    def _accept(st: CrossState, p, piv_idx, pivot, acol, arow, own_lo, own_hi,
                upd) -> CrossState:
        """Append the accepted pivot: extend vip / LU / cores / factors
        (dmrgg.f90:602-757).  own_lo/own_hi bound the locally-owned bond slab
        (whole train on a single device): cross-slab factor slices are
        skipped here and handled by the boundary fixup, mirroring the
        reference's `p > own(me)` / `p < own(me+1)-1` guards
        (dmrgg.f90:715, 730).

        `upd` masks the whole accept: every slab write selects between the
        new border and the existing content of its target slot, so a
        rejected pivot leaves the state bit-identical.  This replaces a
        lax.cond — conditionals take the multi-MB state by value, and the
        resulting buffer copies dominated the sweep (70% in traces); with
        straight-line masked updates XLA keeps the dynamic-update-slices
        in place."""
        ii, jj, kk, qq = piv_idx
        dt = st.cores.dtype
        p = jnp.asarray(p, jnp.int32)
        z = jnp.int32(0)
        s = st.rk[p + 1].astype(jnp.int32)
        rmask = (iR < s).astype(dt)

        def dus(buf, new, old, idx):
            return jax.lax.dynamic_update_slice(
                buf, jnp.where(upd, new, old), idx)

        vip_old = jax.lax.dynamic_slice(st.vip, (p, s, z), (1, 1, 4))
        vip = dus(st.vip, jnp.stack([ii, jj, kk, qq]).astype(jnp.int32)[None, None, :],
                  vip_old, (p, s, z))

        c_new = _at(st.colf, p)[ii, jj, :] * rmask
        u_new = _at(st.rowf, p + 1)[:, kk, qq] * rmask
        lu_c = dus(st.lu_c, c_new[None, None, :],
                   jax.lax.dynamic_slice(st.lu_c, (p, s, z), (1, 1, R)), (p, s, z))
        lu_u = dus(st.lu_u, u_new[None, None, :],
                   jax.lax.dynamic_slice(st.lu_u, (p, s, z), (1, 1, R)), (p, s, z))
        lu_d = dus(st.lu_d, pivot[None, None],
                   jax.lax.dynamic_slice(st.lu_d, (p, s), (1, 1)), (p, s))

        # maintained triangular inverses (bordered-inverse recurrences):
        # L_{s+1}^-1 = [[L^-1, 0], [-c L^-1, 1]],
        # T_{s+1}^-1 = [[T^-1, -T^-1 u / delta], [0, 1/delta]]
        itl_p = _at(st.itl, p)
        new_row = jnp.where(iR == s, 1.0, -(c_new @ itl_p))
        itl = dus(st.itl, new_row[None, None, :],
                  jax.lax.dynamic_slice(st.itl, (p, s, z), (1, 1, R)), (p, s, z))
        itt_p = _at(st.itt, p)
        new_col = jnp.where(iR == s, 1.0 / pivot, -(itt_p @ u_new) / pivot)
        itt = dus(st.itt, new_col[None, :, None],
                  jax.lax.dynamic_slice(st.itt, (p, z, s), (1, R, 1)), (p, z, s))

        # raw fibers into cores (dmrgg.f90:662-685): column slab of core p at
        # (p, :, :, s), row slab of core p+1 at (p+1, s, :, :)
        def old4(buf, idx, shape):
            return jax.lax.dynamic_slice(buf, idx, shape)

        cores = dus(st.cores, acol[None, :, :, None],
                    old4(st.cores, (p, z, z, s), (1, R, N, 1)), (p, z, z, s))
        cores = dus(cores, arow[None, None, :, :],
                    old4(cores, (p + 1, s, z, z), (1, 1, N, R)), (p + 1, s, z, z))

        # incremental factor updates (dmrgg.f90:687-713)
        new_colf = lulib.apply_new_col(_at(st.colf, p), u_new, pivot, acol, s)
        colf = dus(st.colf, new_colf[None, :, :, None],
                   old4(st.colf, (p, z, z, s), (1, R, N, 1)), (p, z, z, s))
        new_rowf = lulib.apply_new_row(_at(st.rowf, p + 1), c_new, arow, s)
        rowf = dus(st.rowf, new_rowf[None, None, :, :],
                   old4(st.rowf, (p + 1, s, z, z), (1, 1, N, R)), (p + 1, s, z, z))

        # left rows: row factor of bond p-1 on core p gains the new column
        # with the bond p-1 L-solve applied (dmrgg.f90:715-728)
        upd_l = upd & (p > own_lo)
        slc_l = _at(st.itl, jnp.maximum(p - 1, 0)) @ acol   # L^-1 acol, (R, N)
        rowf = jax.lax.dynamic_update_slice(
            rowf, jnp.where(upd_l, slc_l[None, :, :, None],
                            old4(rowf, (p, z, z, s), (1, R, N, 1))),
            (p, z, z, s))

        # right cols: col factor of bond p+1 on core p+1 gains the new row
        # with the bond p+1 T-solve applied (dmrgg.f90:730-749)
        upd_r = upd & (p < own_hi - 1)
        slc_r = arow @ _at(st.itt, jnp.minimum(p + 1, d - 2))  # arow T^-1, (N, R)
        colf = jax.lax.dynamic_update_slice(
            colf, jnp.where(upd_r, slc_r[None, None, :, :],
                            old4(colf, (p + 1, s, z, z), (1, 1, N, R))),
            (p + 1, s, z, z))

        apiv = jnp.abs(pivot)
        pivotmax = jnp.where(upd & (st.pivotmax < 0), apiv,
                             jnp.where(upd, jnp.maximum(st.pivotmax, apiv), st.pivotmax))
        pivotmin = jnp.where(upd & (st.pivotmin < 0), apiv,
                             jnp.where(upd, jnp.minimum(st.pivotmin, apiv), st.pivotmin))
        rk = st.rk.at[p + 1].add(jnp.where(upd, 1, 0))
        return st._replace(cores=cores, colf=colf, rowf=rowf, rk=rk, vip=vip,
                           lu_c=lu_c, lu_u=lu_u, lu_d=lu_d, itl=itl, itt=itt,
                           pivotmax=pivotmax, pivotmin=pivotmin)

    def visit_bond(st: CrossState, p, dir_fwd: bool, own_lo=0, own_hi=d - 1,
                   ltab=None, rtab=None, u2=None, lw=None):
        """Hunt + (maybe) accept at bond p.  Returns (state, tape_i, tape_f):
        tape_i (5,) int32 = (accepted, ii, jj, kk, qq); tape_f (2R+1,) =
        (c border, u border, pivot) — the per-sweep record the distributed
        engine exchanges (the reference's 4-int tape, dmrgg.f90:598-604,
        extended with the LU row so replicas replay the LU too).

        dir_fwd is a PYTHON bool (trace-time constant): the sweep driver
        conds once per sweep on the parity and each direction's body is
        compiled with only its own rook pass order (see _rook).

        ltab/rtab: the bond's chain tables; if not supplied they are
        rebuilt by direct scans (the sweep drivers pass precomputed /
        incrementally advanced tables instead — chains.py recurrences)."""
        if ltab is None:
            ltab = left_table(st.vip, p, d)
        if rtab is None:
            rtab = right_table(st.vip, p, d)
        if u2 is None and cfg.piv != -1:
            key, sub = jax.random.split(st.key)
            u2 = jax.random.uniform(sub, (2, NLOT), jnp.float64)
            st = st._replace(key=key)
        if cfg.piv == -1:
            st, piv_idx, pivot, acol, arow = _hunt_full(st, p, ltab, rtab)
        else:
            st, seed, pivot0 = _hunt_lottery(st, p, ltab, rtab, u2, lw)

            def hunt(s):
                if cfg.piv == 0:
                    s, idx, pv, ac, ar = _hunt_piv0(s, p, ltab, rtab, seed, pivot0)
                else:
                    s, idx, pv, ac, ar = _rook(s, p, ltab, rtab, seed, pivot0, dir_fwd)
                return s, tuple(jnp.asarray(x, jnp.int32) for x in idx), pv, ac, ar

            if cfg.adaptive > 0:
                # adaptive gating: the lottery residual is a cheap probe of
                # the bond's best achievable pivot; when an `adaptive`-fold
                # amplification still fails either leg of the two-threshold
                # accept (acceptance requires both, dmrgg.f90:598-600), or
                # the bond is rank-saturated, skip the fiber evaluations —
                # lax.cond executes one branch, so a converged bond costs
                # only its lottery.  The reference has no such gate
                # (it evaluates every bond every sweep until global strike-3).
                gate = ((jnp.abs(pivot0) * cfg.adaptive
                         > cfg.small_element * st.amax)
                        & (jnp.abs(pivot0) * cfg.adaptive
                           > cfg.small_pivot * st.pivotmax_prev)
                        & (st.rk[p + 1] < R))
                dt_ = st.cores.dtype

                def skip(s):
                    return (s, tuple(jnp.asarray(x, jnp.int32) for x in seed),
                            jnp.zeros((), dt_), jnp.zeros((R, N), dt_),
                            jnp.zeros((N, R), dt_))

                st, piv_idx, pivot, acol, arow = jax.lax.cond(gate, hunt, skip, st)
            else:
                st, piv_idx, pivot, acol, arow = hunt(st)

        upd = ((jnp.abs(pivot) > cfg.small_element * st.amax)
               & (jnp.abs(pivot) > cfg.small_pivot * st.pivotmax_prev)
               & (st.rk[p + 1] < R))
        ii, jj, kk, qq = piv_idx
        rmask = (iR < st.rk[p + 1]).astype(st.cores.dtype)
        c_new = _at(st.colf, p)[ii, jj, :] * rmask
        u_new = _at(st.rowf, p + 1)[:, kk, qq] * rmask
        tape_i = jnp.where(upd, jnp.stack([1, ii, jj, kk, qq]).astype(jnp.int32), 0)
        tape_f = jnp.where(upd, jnp.concatenate([c_new, u_new, pivot[None]]), 0.0)
        st = _accept(st, p, piv_idx, pivot, acol, arow, own_lo, own_hi, upd)
        return st, tape_i, tape_f

    def make_sweep_seq(fwd: bool):
        """One full sweep over all bonds in a STATIC direction
        (dmrgg.f90:314-760); the per-sweep dispatch conds on the parity
        ('>>' on odd iterations, dmrgg.f90:316) so each body compiles with
        only its own rook pass order and table-advance recurrence.

        Chain tables: the direction we sweep AWAY from is precomputed once
        (those bonds' vip entries can't change before we reach them); the
        direction we sweep INTO is advanced incrementally — O(d R) per
        sweep instead of O(d^2 R) of per-bond scans."""

        def sweep(args):
            st, lw = args
            key, sub = jax.random.split(st.key)
            U = jax.random.uniform(sub, (d - 1, 2, NLOT), jnp.float64)
            st = st._replace(pivotmax=jnp.full((), -1.0, st.amax.dtype),
                             pivotmin=jnp.full((), -1.0, st.amax.dtype),
                             key=key)
            AT = all_right_tables(st.vip, d) if fwd else all_left_tables(st.vip, d)
            tab0 = jnp.zeros((R, d), st.vip.dtype)   # = LT[0] and RT[d-2]

            def body(idx, carry):
                s, tab = carry
                p = idx if fwd else d - 2 - idx
                ltab = tab if fwd else _at(AT, p)
                rtab = _at(AT, p) if fwd else tab
                s = visit_bond(s, p, fwd, ltab=ltab, rtab=rtab,
                               u2=_at(U, p), lw=lw)[0]
                vip_p = _at(s.vip, p)
                tab = (advance_left(tab, vip_p, p) if fwd
                       else advance_right(tab, vip_p, p - 1))
                return s, tab

            st, _ = jax.lax.fori_loop(0, d - 1, body, (st, tab0))
            return st._replace(pivotmax_prev=st.pivotmax)

        return sweep

    _sweep_seq = {True: make_sweep_seq(True), False: make_sweep_seq(False)}

    def sweep_fn_inner(st: CrossState, it, lw=None) -> CrossState:
        """Direction-alternating sweep: ONE cond per sweep selecting the
        forward or backward static body (a per-sweep state select is
        negligible; per-visit conds were the costly pattern — see
        sweep_capped_inner, which established this dispatch)."""
        dir_fwd = (it % 2) == 1
        return jax.lax.cond(dir_fwd, _sweep_seq[True], _sweep_seq[False],
                            (st, lw))

    # -------------------------------------------------- capped bond visit
    def _visit_bond_capped(st: CrossState, p: int, u2, lw=None):
        """Bond visit with PER-BOND capped integrand batches (cfg.caps):
        only the fun-call shapes shrink — fibers are evaluated at
        (Rl, N)/(N, Rr) with Rl/Rr = min(R, cap of the adjacent bond) and
        zero-embedded into the full-R buffers, so the LU/factor machinery
        is untouched.  p is STATIC (the capped sweep unrolls bonds), and
        rook passes run col,row,col,... regardless of sweep direction
        (the skipcol alternation, dmrgg.f90:517, needs equal-shape
        batches to stay branch-free; the capped mode trades it for the
        smaller per-side batches — a stochastic pivot-order difference
        within the usual envelope)."""
        caps = cfg.caps
        Rl = 1 if p == 0 else min(R, int(caps[p - 1]))
        Rb = min(R, int(caps[p]))
        Rr = 1 if p == d - 2 else min(R, int(caps[p + 1]))
        NLOTp = Rl + N + N + Rr
        iRl = jnp.arange(Rl)
        iRr = jnp.arange(Rr)
        ltab = left_table(st.vip, p, d)
        rtab = right_table(st.vip, p, d)
        dt = st.cores.dtype

        # ---- lottery over the capped candidate spaces
        colmask = ((iRl[:, None] < st.rk[p]) & (iN[None, :] < n_arr[p])).reshape(-1)
        rowmask = ((iRr[:, None] < st.rk[p + 2]) & (iN[None, :] < n_arr[p + 1])).reshape(-1)
        vb = _at(st.vip, p)
        smask = iR < st.rk[p + 1]
        used_col = jnp.zeros((Rl * N,), bool).at[
            jnp.minimum(vb[:, 0], Rl - 1) * N + vb[:, 1]].max(smask)
        used_row = jnp.zeros((Rr * N,), bool).at[
            jnp.minimum(vb[:, 3], Rr - 1) * N + vb[:, 2]].max(smask)
        f32 = jnp.float32
        wcol = (colmask & ~used_col).astype(f32)
        wrow = (rowmask & ~used_row).astype(f32)
        if cfg.wlot and lw is not None:
            # arbitrary-weights lottery (rnd.f90:105-126): same layout as
            # _hunt_lottery — lin_c = i*N + j weights mode p, lin_r =
            # q*N + k weights mode p+1
            wcol = wcol * jnp.tile(jnp.abs(_at(lw, p)), Rl).astype(f32)
            wrow = wrow * jnp.tile(jnp.abs(_at(lw, p + 1)), Rr).astype(f32)
        # f32 CDFs via triangular-ones matmuls (see _hunt_lottery)
        cdf_c = jnp.dot(wcol, jnp.triu(jnp.ones((Rl * N, Rl * N), f32)),
                        precision=_HIGHEST)
        cdf_r = jnp.dot(wrow, jnp.triu(jnp.ones((Rr * N, Rr * N), f32)),
                        precision=_HIGHEST)
        below = f32(1.0 - 2.0 ** -20)
        u2c = u2[0, :NLOTp].astype(f32)
        u2r = u2[1, :NLOTp].astype(f32)
        t_c = jnp.minimum(u2c * jnp.where(cdf_c[-1] > 0, cdf_c[-1], 1.0),
                          cdf_c[-1] * below)
        t_r = jnp.minimum(u2r * jnp.where(cdf_r[-1] > 0, cdf_r[-1], 1.0),
                          cdf_r[-1] * below)
        lin_c = jnp.minimum(
            jnp.searchsorted(cdf_c, t_c, side="right", method="compare_all"),
            Rl * N - 1).astype(jnp.int_)
        lin_r = jnp.minimum(
            jnp.searchsorted(cdf_r, t_r, side="right", method="compare_all"),
            Rr * N - 1).astype(jnp.int_)
        i_c, j_c = _decode_div(lin_c, N)
        q_c, k_c = _decode_div(lin_r, N)
        nlot_act = st.rk[p] + n_arr[p] + n_arr[p + 1] + st.rk[p + 2]
        candmask = jnp.arange(NLOTp) < nlot_act
        ind = assemble_indices(ltab, rtab, p, i_c, j_c, k_c, q_c, d)
        b = fun(ind)
        amax = jnp.maximum(st.amax,
                           jnp.max(jnp.where(candmask, jnp.abs(b), 0.0)))
        neval = st.neval + nlot_act.astype(jnp.int64)
        padded = st.padded + NLOTp
        from ..ops.dense import row_lookup

        rmask = (iR < st.rk[p + 1]).astype(dt)
        cf = row_lookup(_at(st.colf, p)[:Rl].reshape(Rl * N, R), lin_c)
        rf = row_lookup(_at(st.rowf, p + 1)[:, :, :Rr].reshape(R, N * Rr),
                        k_c * Rr + q_c, axis=1)
        resid = b - jnp.sum(cf * rf * rmask[None, :], axis=1)
        best = jnp.argmax(jnp.where(candmask, jnp.abs(resid), -1.0))
        ii, jj = i_c[best], j_c[best]
        kk, qq = k_c[best], q_c[best]
        pivot = resid[best]
        st = st._replace(amax=amax, neval=neval, padded=padded)

        # ---- rook passes: capped fiber batches, static col/row order
        acol_c = jnp.zeros((Rl, N), dt)
        arow_c = jnp.zeros((N, Rr), dt)
        c = dict(ii=ii, jj=jj, kk=kk, qq=qq, pivot=pivot,
                 acol=acol_c, arow=arow_c,
                 havecol=jnp.asarray(False), haverow=jnp.asarray(False),
                 crs=jnp.asarray(0, jnp.int32), done=jnp.asarray(cfg.piv == 0),
                 amax=amax, neval=neval)
        cmask2 = (iRl[:, None] < st.rk[p]) & (iN[None, :] < n_arr[p])
        rmask2 = (iN[:, None] < n_arr[p + 1]) & (iRr[None, :] < st.rk[p + 2])

        def col_pass(c, force=False):
            live = force | ~c["done"]
            ig = jnp.repeat(iRl, N)
            jg = jnp.tile(iN, Rl)
            ind = assemble_indices(ltab, rtab, p, ig, jg,
                                   jnp.full_like(ig, c["kk"]),
                                   jnp.full_like(ig, c["qq"]), d)
            vals = jnp.where(cmask2, fun(ind).reshape(Rl, N), 0.0)
            amax = jnp.maximum(c["amax"], jnp.max(jnp.abs(vals)))
            nev = c["neval"] + jnp.where(live, st.rk[p] * n_arr[p], 0).astype(jnp.int64)
            u = _at(st.rowf, p + 1)[:, c["kk"], c["qq"]] * rmask
            bcol = vals - jnp.tensordot(_at(st.colf, p)[:Rl], u, axes=[[2], [0]])
            sc = jnp.where(cmask2, jnp.abs(bcol), -1.0)
            i2 = jnp.argmax(jnp.max(sc, axis=1))
            j2 = jnp.argmax(sc[i2])
            crs = c["crs"] + 1
            havecol = c["havecol"] | True
            budget = havecol & c["haverow"] & (crs >= 2 * cfg.piv)
            stat = havecol & c["haverow"] & (i2 == c["ii"]) & (j2 == c["jj"])
            upd = ~budget & (cfg.piv > 0)   # piv=0 evaluates, never moves
            new = dict(ii=jnp.where(upd, i2, c["ii"]),
                       jj=jnp.where(upd, j2, c["jj"]),
                       kk=c["kk"], qq=c["qq"],
                       pivot=jnp.where(upd, bcol[i2, j2], c["pivot"]),
                       acol=vals, arow=c["arow"],
                       havecol=havecol, haverow=c["haverow"], crs=crs,
                       done=budget | (upd & stat), amax=amax, neval=nev)
            return jax.tree_util.tree_map(
                lambda a, b2: jnp.where(live, a, b2), new, c)

        def row_pass(c, force=False):
            live = force | ~c["done"]
            kg = jnp.repeat(iN, Rr)
            qg = jnp.tile(iRr, N)
            ind = assemble_indices(ltab, rtab, p, jnp.full_like(kg, c["ii"]),
                                   jnp.full_like(kg, c["jj"]), kg, qg, d)
            vals = jnp.where(rmask2, fun(ind).reshape(N, Rr), 0.0)
            amax = jnp.maximum(c["amax"], jnp.max(jnp.abs(vals)))
            nev = c["neval"] + jnp.where(live, n_arr[p + 1] * st.rk[p + 2], 0).astype(jnp.int64)
            cw = _at(st.colf, p)[c["ii"], c["jj"], :] * rmask
            brow = vals - jnp.tensordot(cw, _at(st.rowf, p + 1)[:, :, :Rr],
                                        axes=[[0], [0]])
            sr = jnp.where(rmask2, jnp.abs(brow), -1.0)
            k2 = jnp.argmax(jnp.max(sr, axis=1))
            q2 = jnp.argmax(sr[k2])
            crs = c["crs"] + 1
            haverow = c["haverow"] | True
            budget = c["havecol"] & haverow & (crs >= 2 * cfg.piv)
            stat = c["havecol"] & haverow & (k2 == c["kk"]) & (q2 == c["qq"])
            upd = ~budget & (cfg.piv > 0)   # piv=0 evaluates, never moves
            new = dict(ii=c["ii"], jj=c["jj"],
                       kk=jnp.where(upd, k2, c["kk"]),
                       qq=jnp.where(upd, q2, c["qq"]),
                       pivot=jnp.where(upd, brow[k2, q2], c["pivot"]),
                       acol=c["acol"], arow=vals,
                       havecol=c["havecol"], haverow=haverow, crs=crs,
                       done=budget | (upd & stat), amax=amax, neval=nev)
            return jax.tree_util.tree_map(
                lambda a, b2: jnp.where(live, a, b2), new, c)

        n_pairs = max(cfg.piv, 1)
        for t in range(n_pairs):
            # piv == 0: one forced col + row evaluation of the seed fibers
            c = col_pass(c, force=cfg.piv == 0)
            c = row_pass(c, force=cfg.piv == 0)
        padded = st.padded + n_pairs * (Rl * N + N * Rr)
        st = st._replace(amax=c["amax"], neval=c["neval"], padded=padded)
        ii, jj, kk, qq = c["ii"], c["jj"], c["kk"], c["qq"]
        pivot = c["pivot"]
        # embed the capped fibers into the full-R buffers
        acol = jnp.zeros((R, N), dt).at[:Rl].set(c["acol"])
        arow = jnp.zeros((N, R), dt).at[:, :Rr].set(c["arow"])

        upd = ((jnp.abs(pivot) > cfg.small_element * st.amax)
               & (jnp.abs(pivot) > cfg.small_pivot * st.pivotmax_prev)
               & (st.rk[p + 1] < Rb))
        st = _accept(st, p, (ii, jj, kk, qq), pivot, acol, arow, 0, d - 1, upd)
        return st

    def make_sweep_capped(fwd: bool):
        """One capped sweep in a STATIC direction (bond order unrolled —
        per-bond batch shapes must be trace-time constants)."""

        def sweep(args) -> CrossState:
            st, lw = args
            key, sub = jax.random.split(st.key)
            U = jax.random.uniform(sub, (d - 1, 2, NLOT), jnp.float64)
            st = st._replace(pivotmax=jnp.full((), -1.0, st.amax.dtype),
                             pivotmin=jnp.full((), -1.0, st.amax.dtype),
                             key=key)
            order = range(d - 1) if fwd else range(d - 2, -1, -1)
            for p in order:
                st = _visit_bond_capped(st, p, U[p], lw)
            return st._replace(pivotmax_prev=st.pivotmax)

        return sweep

    def sweep_capped_inner(st: CrossState, it, lw=None) -> CrossState:
        """Capped sweep with the usual direction alternation: ONE cond per
        sweep selecting the forward or backward unrolled body (a per-sweep
        state copy is negligible; the per-visit conds the engine avoids
        elsewhere were the costly pattern)."""
        dir_fwd = (it % 2) == 1
        return jax.lax.cond(dir_fwd, make_sweep_capped(True),
                            make_sweep_capped(False), (st, lw))

    # ------------------------------------------------------- Jacobi sweep
    # (all-bonds-batched sweep family: cross/engine_jacobi.py)
    from .engine_jacobi import build_jacobi

    chain_ev = None
    if chain is not None:
        from .chain_eval import ChainEvaluator

        chain_ev = ChainEvaluator(chain, d)
    (make_sweep_jacobi, jacobi_hunt, jacobi_apply,
     _sweep_jacobi_body) = build_jacobi(
        cfg, fun, d, N, R, NLOT, iR, iN, n_arr, _decode_div,
        chain_ev=chain_ev)

    if cfg.jacobi:
        _sweep_jac = {True: make_sweep_jacobi(True),
                      False: make_sweep_jacobi(False)}

    def sweep_jacobi_inner(st: CrossState, it, lw=None, cs=None):
        """Jacobi sweep with the usual direction alternation: ONE cond per
        sweep selecting the static forward/backward pass order.  cs:
        optional carried packed interface states (chain path); when given
        the return is (st, cs')."""
        dir_fwd = (it % 2) == 1
        args = (st, lw) if cs is None else (st, lw, cs)
        return jax.lax.cond(dir_fwd, _sweep_jac[True], _sweep_jac[False],
                            args)

    if cfg.caps is not None:
        sweep_impl = sweep_capped_inner
    elif cfg.jacobi:
        sweep_impl = sweep_jacobi_inner
    else:
        sweep_impl = sweep_fn_inner
    sweep_fn = jax.jit(sweep_impl)

    def value_mat(st: CrossState, w, c) -> jax.Array:
        """LU-solved (R, R) contraction matrix of core c against weights
        w[c] (the ttqq core + dtt_lua application, dmrgg.f90:986-992)."""
        curr = jnp.einsum("inj,n->ij", _at(st.cores, c), _at(w, c))  # (R, R)
        solved_r = _at(st.itl, jnp.maximum(c - 1, 0)) @ curr
        curr = jnp.where(c > 0, solved_r, curr)
        solved_c = curr @ _at(st.itt, jnp.minimum(c, d - 2))
        return jnp.where(c < d - 1, solved_c, curr)

    def _value_mats(st: CrossState, w) -> jax.Array:
        """All d LU-solved contraction matrices of value_mat, batched:
        mats[c] = value_mat(st, w, c), with the c-1 / c clamps rendered as
        contiguous shifts."""
        # broadcast-multiply + reduce-sum rather than einsum, a form shaped
        # for the first target, whose batched f64 dot_general was serial
        cidx = jnp.arange(d)
        curr = jnp.sum(st.cores * w[:, None, :, None], axis=2)    # (d, R, R)
        itl_prev = jnp.concatenate([st.itl[:1], st.itl], axis=0)  # (d, R, R)
        solved_r = jnp.sum(itl_prev[:, :, :, None] * curr[:, None], axis=2)
        curr = jnp.where((cidx > 0)[:, None, None], solved_r, curr)
        itt_c = jnp.concatenate([st.itt, st.itt[-1:]], axis=0)
        solved_c = jnp.sum(curr[:, :, :, None] * itt_c[:, None], axis=2)
        return jnp.where((cidx < d - 1)[:, None, None], solved_c, curr)

    @jax.jit
    def value_fn(st: CrossState, w) -> jax.Array:
        """Contract the current cross against per-mode weights w (d, N),
        applying the growing-LU inverses (ttqq + dtt_lua + dtt_quad,
        dmrgg.f90:975-1006).

        The chain is norm-balanced with EXACT power-of-2 rescales
        (exponent tracked separately) — the engine's rendering of the
        reference's geometric-mean core balancing (dtt_ort,
        tt.f90:150-197): at d ~ 256+ the raw partial products span
        1e+/-250, beyond even binary64 near the reference's tt_size=2048,
        and far beyond f32's ~1e+/-38.

        The product runs as a log2(d)-depth pairwise tree
        (ops.dense.balanced_matmul_chain) instead of a d-step serial
        fori_loop: at C_256 the serial chain is 255 dependent (R, R)
        matmuls per sweep, the tree is 8 batched levels."""
        from ..ops.dd import _exact_pow2
        from ..ops.dense import balanced_matmul_chain

        P, ex = balanced_matmul_chain(_value_mats(st, w))
        # v0 = e_0 row vector: the chain value is entry (0, 0) of the
        # ordered product M_0 M_1 ... M_{d-1}
        return P[0, 0] * _exact_pow2(ex)

    # ------------------------------------------------------------ fused run
    _run_cache: dict = {}

    def make_run_fn(max_sweeps: int, with_quad: bool, accuracy: float | None):
        ck = (max_sweeps, with_quad, accuracy)
        if ck in _run_cache:
            return _run_cache[ck]
        _run_cache[ck] = _make_run_fn(max_sweeps, with_quad, accuracy)
        return _run_cache[ck]

    def _make_run_fn(max_sweeps: int, with_quad: bool, accuracy: float | None):
        """Whole-cross driver fused into ONE device call: sweeps, per-sweep
        quadrature values, and the strike-based stopping rule
        (dmrgg.f90:1010-1019) all run inside a lax.while_loop, eliminating
        per-sweep host round-trips (the device replacement for the
        reference's per-iteration rank-0 reporting).

        it0/strike0 allow a chunked-growth resume: the global iteration
        counter drives the sweep direction alternation and the quiet-sweep
        strike carries across rank-padding chunks (cross(rank_chunks=...))."""

        # chain+jacobi: carry the packed interface states through the
        # run loop — built ONCE here by scan, then maintained
        # incrementally by update_states after every apply (vip is
        # append-only, so existing rows never go stale, and the 4
        # per-sweep Hillis-Steele rebuild scans are saved)
        use_cs = cfg.jacobi and (chain_ev is not None) and cfg.caps is None

        @jax.jit
        def run_fn(st: CrossState, w, it0=jnp.asarray(1, jnp.int32),
                   strike0=jnp.asarray(0, jnp.int32)):
            dt = st.amax.dtype
            vals0 = jnp.zeros((max_sweeps + 1,), dt)
            pmax0 = jnp.zeros((max_sweeps + 1,), dt)
            nev0 = jnp.zeros((max_sweeps + 1,), jnp.int64)
            if with_quad:
                vals0 = vals0.at[0].set(value_fn(st, w))
            cs0 = (chain_ev.states_from_vip(st.vip) if use_cs
                   else jnp.zeros((), jnp.int32))

            def cond(carry):
                st, cs, t, strike, vals, pmax, nev, done = carry
                return ~done

            def body(carry):
                st, cs, t, strike, vals, pmax, nev, done = carry
                lwarg = w if cfg.wlot else None
                if use_cs:
                    st, cs = sweep_impl(st, it0 + t - 1, lwarg, cs)
                else:
                    st = sweep_impl(st, it0 + t - 1, lwarg)
                if with_quad:
                    vals = vals.at[t].set(value_fn(st, w))
                pmax = pmax.at[t].set(st.pivotmax)
                nev = nev.at[t].set(st.neval)
                ready = t + 1 >= max_sweeps + 1
                if accuracy is not None:
                    quiet = st.pivotmax <= accuracy * st.amax
                    strike = jnp.where(quiet, strike + 1, 0)
                    ready = ready | (strike >= 3)
                return (st, cs, t + 1, strike, vals, pmax, nev, ready)

            init = (st, cs0, jnp.asarray(1, jnp.int32), strike0,
                    vals0, pmax0, nev0, jnp.asarray(max_sweeps < 1))
            st, _, t, strike, vals, pmax, nev, _ = jax.lax.while_loop(
                cond, body, init)
            return st, t - 1, vals, pmax, nev, strike

        return run_fn

    _full_cache: dict = {}

    def make_full_fn(max_sweeps: int, with_quad: bool, accuracy: float | None):
        """Whole cross — init, fused multi-sweep run, LU finalization — as
        ONE device executable returning the solved cores plus a single
        packed result vector.  Every device call and every device->host
        transfer costs latency; this path leaves exactly one dispatch and
        one small transfer on the critical path (the cores stay on
        device)."""
        ck = (max_sweeps, with_quad, accuracy)
        if ck not in _full_cache:
            run_fn = make_run_fn(max_sweeps, with_quad, accuracy)

            @jax.jit
            def full_fn(key, w):
                st = init_fn(key)
                st, last_it, vals, pmax, nev, _ = run_fn(st, w)
                solved = finalize_fn(st)
                ft = vals.dtype
                # vip rides along (exact: indices < 2^20 << f32/f64
                # mantissa) so refine_sweeps can seed the maxvol pivot
                # sets WITHOUT dropping this fused export-cached path
                packed = jnp.concatenate([
                    vals, pmax, nev.astype(ft), st.rk.astype(ft),
                    st.vip.reshape(-1).astype(ft),
                    jnp.stack([last_it.astype(ft), st.neval.astype(ft),
                               st.padded.astype(ft)]),
                ])
                return solved, packed

            _full_cache[ck] = full_fn
        return _full_cache[ck]

    @jax.jit
    def finalize_fn(st: CrossState) -> jax.Array:
        """Apply the LU inverses to all raw cores in ONE compiled call
        (dtt_lua, dmrgg.f90:1169-1258).  Ranks stay traced so a single
        executable serves every rank pattern (an eager per-core version
        would recompile per concrete rank value).

        The per-core solves are independent, so the former d-step
        fori_loop (255 serial iterations at C_256) is two batched
        einsums with the boundary clamps as contiguous shifts."""
        # einsum (not the faster sum-form): the solved cores ARE the
        # returned train, so they get the dot_general lowering's more
        # accurate pair products (engine_jacobi.jacobi_apply note); this
        # runs once per cross
        cidx = jnp.arange(d)
        itl_prev = jnp.concatenate([st.itl[:1], st.itl], axis=0)  # (d, R, R)
        solved = jnp.einsum("cab,cbnj->canj", itl_prev, st.cores)
        g = jnp.where((cidx > 0)[:, None, None, None], solved, st.cores)
        itt_c = jnp.concatenate([st.itt, st.itt[-1:]], axis=0)
        solved = jnp.einsum("canb,cbj->canj", g, itt_c)
        return jnp.where((cidx < d - 1)[:, None, None, None], solved, g)

    return EngineKit(
        cfg=cfg, init_fn=init_fn, sweep_fn=sweep_fn, value_fn=value_fn,
        make_run_fn=make_run_fn, visit_bond=visit_bond, value_mat=value_mat,
        eval_col_fiber=_eval_col_fiber, eval_row_fiber=_eval_row_fiber,
        init_neval=cfg.snum * int(min(cfg.n)) + int(sum(cfg.n)),
        finalize_fn=finalize_fn, make_full_fn=make_full_fn,
        jacobi_hunt=jacobi_hunt, jacobi_apply=jacobi_apply,
        value_mats=_value_mats,
    )


def finalize(st: CrossState, cfg: CrossConfig, kit=None) -> TT:
    """Apply the LU inverses to the raw cores and trim the padding into a
    proper TT (dtt_lua, dmrgg.f90:1169-1258, single-process path).

    With a kit, the solves run as ONE jitted call (finalize_fn); the eager
    fallback compiles per concrete rank value and is kept for kit-less use."""
    d = cfg.d
    rk = np.asarray(st.rk)
    if kit is not None and kit.finalize_fn is not None:
        solved = np.asarray(kit.finalize_fn(st))
        return TT(tuple(jnp.asarray(solved[c][: rk[c], : cfg.n[c], : rk[c + 1]])
                        for c in range(d)))
    cores = []
    for c in range(d):
        g = st.cores[c]
        if c > 0:
            lu = lulib.GrowingLU(st.lu_c[c - 1], st.lu_u[c - 1], st.lu_d[c - 1])
            g = lulib.solve_rows(lu, int(rk[c]), g)
        if c < d - 1:
            lu = lulib.GrowingLU(st.lu_c[c], st.lu_u[c], st.lu_d[c])
            g = lulib.solve_cols(lu, int(rk[c + 1]), g)
        cores.append(g[: rk[c], : cfg.n[c], : rk[c + 1]])
    return TT(tuple(cores))


def cross(
    fun: Callable,
    n: Sequence[int],
    max_rank: int = 20,
    accuracy: float | None = None,
    pivoting: int = 1,
    quad: Sequence | None = None,
    truth: float | None = None,
    key: int | jax.Array = 0,
    dtype=jnp.float64,
    verbose: bool = False,
    init_state: CrossState | None = None,
    return_state: bool = False,
    return_pivots: bool = False,
    host_reeval: "Callable | bool | None" = None,
    max_sweeps: int | None = None,
    small_element: float | None = None,
    small_pivot: float | None = None,
    rank_chunks: Sequence[int] | str | None = None,
    weighted_lottery: bool = False,
    oversample: int = 0,
    refine_sweeps: int = 0,
    sweep_mode: str = "sequential",
    rank_caps: Sequence[int] | None = None,
    adaptive: float | bool = 0.0,
    chain=None,
) -> CrossResult:
    """Approximate the black-box tensor fun in TT format by DMRG-greedy
    cross interpolation (public API mirroring dtt_dmrgg's contract,
    dmrgg.f90:11-26).

    fun: batched integrand, ind (B, d) int32 -> (B,) values.
    n: per-mode sizes.  max_rank: padded/maximum TT rank.  accuracy: stop
    when max accepted pivot <= accuracy * amax for 3 consecutive sweeps.
    pivoting: -1 full / 0 lottery / k>=1 rook with up to 2k passes.
    quad: optional per-mode weight vectors -> per-sweep value + convergence.
    return_pivots: attach a light vip/rk shim as res.state (enough for
    cross/skeleton.py::extract_skeleton) WITHOUT leaving the
    single-dispatch fast path (return_state=True materializes the full
    CrossState and runs per-sweep dispatches); plain single-chunk runs only.
    host_reeval: re-evaluate the frozen pivot skeleton with a correctly-
    rounded host integrand and rebuild/round/value the train all-host —
    built as the accuracy cure for a platform whose emulated device f64
    capped the train's digits.  True auto-derives the host
    twin by running the SAME traced integrand on the CPU x64 backend
    (skeleton.py::derive_host_fun); a callable ``fun_np(ind)->(B,) f64``
    overrides it (e.g. a hand-written numpy integrand).
    rank_chunks: rank-padding growth schedule (increasing, last = max_rank),
    or "auto" for ~4 evenly spaced levels: early sweeps run at a small
    padded rank so the ACTUAL evaluated batch sizes track the reference's
    exact counts (~1.25x at 4 levels instead of ~R/rank per sweep); the
    state is re-embedded between chunks (state.pad_state).  Each chunk
    compiles its own executable.
    oversample: cross-and-round — run the cross at max_rank + oversample,
    then TT-SVD-truncate to max_rank.  Greedy-append pivot selection is
    bounded ~0.5-1 digit short of the TT-SVD optimum at fixed rank (even
    full pivoting); rounding an
    oversampled cross recovers near-optimal fixed-rank accuracy at
    ~(1 + oversample/max_rank)^2 x the evaluations (e.g. MVN d=6 rank 20:
    5.9-6.5 digits greedy, 6.72 full pivoting, 7.4 with oversample=6).
    refine_sweeps: pivot REPLACEMENT — after the greedy cross, run k
    alternating-maxvol sweeps (cross/maxvol.py) seeded with the greedy
    pivot sets, re-selecting every bond's index sets by maximum volume.
    Breaks the greedy-append ceiling WITHOUT rank inflation (MVN d=6
    rank 20: 5.9 greedy -> ~6.8-7.2) at ~2 greedy-runs of extra
    evaluations per sweep.  Composes with oversample: cross at
    max_rank+oversample, refine the pivots there, round back (raises the
    fixed-rank digit floor past either pass alone).
    sweep_mode: "sequential" (default — the reference's exact bond visit
    order, dmrgg.f90:314-323) or "jacobi" — all bonds hunt concurrently
    against start-of-sweep factors, one sweep = a FIXED number of large
    batched integrand calls independent of d (the throughput mode for
    long chains; other bonds' pivots land one sweep late, the staleness
    license the reference's MPI decomposition already grants,
    dmrgg.f90:822-850).
    rank_caps: per-bond rank caps (d-1,) — e.g. the rank profile of a
    previous run.  Integrand batches shrink to the capped per-bond fiber
    sizes (sweeps unroll statically over bonds), closing the padded-work
    gap left by a single global padded rank on rank-heterogeneous trains;
    combine with rank_chunks for padded_ratio ~ 1.1 on the C_6 bench.
    Small-d configs only (unrolled compile); not with sweep_mode="jacobi".
    adaptive: adaptive hunt gating (True = margin 4096, or an explicit
    margin float): skip a bond's rook/piv0 fiber evaluations when an
    `adaptive`-fold amplification of its lottery residual still fails
    either acceptance threshold (acceptance requires clearing both,
    dmrgg.f90:598-600), or the bond is rank-saturated.  Converged bonds
    then cost ~2(R+N) lottery probes instead of ~2*piv*R*N fiber evals per
    sweep — BELOW the reference's evaluation count (it revisits every bond
    fully until the global strike-3 stop).  Heuristic: a pivot whose
    residual hides > `adaptive`-fold above the lottery's best draw is
    skipped that sweep (the lottery re-probes every sweep, so a gated bond
    is reconsidered, not frozen).  Sequential sweeps with pivoting >= 0.
    chain: optional cross/chain_eval.py::ChainSpec for a chain-structured
    integrand (an associative lift/merge/finalize monoid over the mode
    axis, e.g. apps.ising.ising_c_chain).  The jacobi sweep family then
    evaluates hunt candidates in O(1) from cached per-bond interface
    states instead of O(d) per entry — the decisive long-chain
    accelerant (C_256).  Values agree with fun to rounding order;
    n_evals accounting is unchanged.
    NOTE — this is an evaluation-BUDGET feature, not a wall-time one: the
    per-bond lax.cond gating costs more than the skipped fibers save when
    the integrand is cheap traced code (measured: stdnorm d=10 saves 28%
    of evals at identical digits but runs ~36% slower; accept-heavy runs
    gate nothing).  Use it when integrand calls have real external cost
    (host callbacks, expensive coefficient tensors at large d).
    """
    n = tuple(int(x) for x in n)
    d = len(n)
    if d < 2:
        raise ValueError("cross requires d >= 2")
    if max_rank < 2:
        raise ValueError("max_rank must be >= 2")
    if host_reeval is True:
        # auto-derive the host twin: the SAME traced integrand on the CPU
        # x64 backend (true f64) — no hand-written numpy twin required;
        # fun_np-style callables stay accepted as explicit overrides
        from .skeleton import derive_host_fun

        host_reeval = derive_host_fun(fun)
    elif host_reeval is False:
        host_reeval = None
    if host_reeval is not None and (rank_chunks is not None or refine_sweeps
                                    or init_state is not None):
        # the host rebuild rides the fused fast path's packed pivots (the
        # same constraint as return_pivots below)
        raise ValueError("host_reeval supports plain or oversampled "
                         "single-chunk runs only")
    if return_pivots and (oversample or rank_chunks is not None
                          or refine_sweeps or init_state is not None):
        # the light pivot shim rides the fused fast path's packed vip;
        # composite recursions materialize full state anyway — use
        # return_state there
        raise ValueError("return_pivots supports the plain single-chunk "
                         "run only; use return_state=True otherwise")
    if oversample:
        if return_state or init_state is not None:
            raise ValueError("oversample is incompatible with state passing")
        # refine_sweeps COMPOSES with oversample: cross at R+k, maxvol-
        # replace the pivots at the inflated rank, then round to R.  The
        # composition raises the fixed-rank digit FLOOR past either pass
        # alone (C_6 r24 8-key envelope: greedy 12.1-12.9, oversample=6
        # 13.1-14.5, +refine_sweeps=1 13.5-15.4) for ~2.4x the oversampled
        # evaluations — the quality sweet spot where oversample alone is
        # the efficiency one (CPU envelopes).
        r_over = max_rank + int(oversample)
        # an explicit chunk schedule must be extended to the inflated rank
        chunks_over = rank_chunks
        if rank_chunks is not None and rank_chunks != "auto":
            chunks_over = [int(x) for x in rank_chunks if int(x) < r_over] + [r_over]
        # per-bond caps get the same oversampling headroom (the rounding
        # pass truncates back to max_rank globally); dropping them here
        # would silently ignore the caller's padded-work contract
        caps_over = rank_caps
        if rank_caps is not None:
            caps_over = [int(x) + int(oversample) for x in rank_caps]
        if host_reeval is not None:
            # device-pivots / host-data split: cross at the inflated rank
            # on device, re-evaluate the frozen skeleton with the host
            # integrand, round + value all-host
            res = cross(fun, n, max_rank=r_over,
                        accuracy=accuracy, pivoting=pivoting, quad=quad,
                        truth=truth, key=key, dtype=dtype, verbose=verbose,
                        max_sweeps=max_sweeps,
                        small_element=small_element, small_pivot=small_pivot,
                        weighted_lottery=weighted_lottery,
                        sweep_mode=sweep_mode, adaptive=adaptive,
                        rank_caps=caps_over, return_pivots=True,
                        chain=chain)
            res = _apply_host_reeval(res, host_reeval, n, max_rank,
                                     quad, truth)
            if not return_state:
                res.state = None
            return res
        res = cross(fun, n, max_rank=r_over,
                    accuracy=accuracy, pivoting=pivoting, quad=quad,
                    truth=truth, key=key, dtype=dtype, verbose=verbose,
                    max_sweeps=max_sweeps,
                    small_element=small_element, small_pivot=small_pivot,
                    rank_chunks=chunks_over, weighted_lottery=weighted_lottery,
                    sweep_mode=sweep_mode, adaptive=adaptive,
                    rank_caps=caps_over, refine_sweeps=refine_sweeps,
                    chain=chain)
        return round_and_revalue(res, max_rank, quad, truth)
    se, sp = precision_thresholds(dtype)
    # acceptance thresholds are overridable: the per-dtype defaults
    # (dmrgg.f90:62-84) reject pivots 5+ orders below the current max,
    # which truncates quantics crosses whose bond spectra decay
    # geometrically (small_pivot ~ 1e-14 is appropriate there)
    if small_element is not None:
        se = float(small_element)
    if small_pivot is not None:
        sp = float(small_pivot)
    if weighted_lottery and quad is None:
        raise ValueError("weighted_lottery requires quad weights")
    if refine_sweeps:
        # (oversample is falsy here: its branch above composes refine into
        # the inflated recursion and returns)
        user_return_state = return_state
        # the refinement seeds from the pivot sets; the fused fast path
        # ships vip in its packed output, so only paths that cannot
        # (chunked growth, resume) need the full state materialized
        if rank_chunks is not None or init_state is not None:
            return_state = True
    if sweep_mode not in ("sequential", "jacobi", "jacobi-rb"):
        raise ValueError(f"unknown sweep_mode {sweep_mode!r}")
    if sweep_mode.startswith("jacobi") and int(pivoting) < 0:
        # fail at the API boundary, not as a NotImplementedError from
        # engine tracing (the batched jacobi hunt has no full-pivoting
        # superblock variant)
        raise ValueError("sweep_mode='jacobi' requires pivoting >= 0")
    adaptive = 4096.0 if adaptive is True else float(adaptive)
    if adaptive > 0:
        if int(pivoting) < 0:
            raise ValueError("adaptive gating requires pivoting >= 0 "
                             "(full pivoting has no lottery probe)")
        if sweep_mode.startswith("jacobi"):
            raise ValueError("adaptive gating applies to sequential sweeps")
    caps = None
    if rank_caps is not None:
        caps = tuple(int(x) for x in rank_caps)
        if len(caps) != d - 1 or min(caps) < 1:
            raise ValueError(f"rank_caps must be d-1 = {d - 1} positive "
                             f"per-bond caps; got {caps}")
        if sweep_mode.startswith("jacobi"):
            raise ValueError("rank_caps is not supported with jacobi sweeps")
        if int(pivoting) < 0:
            raise ValueError("rank_caps requires pivoting >= 0")
        if adaptive > 0:
            raise ValueError("adaptive gating is not supported with "
                             "rank_caps (the capped sweep shrinks batches "
                             "statically instead)")
    cfg = CrossConfig(d=d, n=n, N=max(n), R=max_rank, piv=int(pivoting),
                      small_element=se, small_pivot=sp,
                      wlot=bool(weighted_lottery),
                      jacobi=sweep_mode.startswith("jacobi"),
                      rb=sweep_mode == "jacobi-rb", caps=caps,
                      adaptive=adaptive)
    kit = get_engine(fun, cfg, chain=chain)
    init_fn, value_fn, make_run_fn = kit.init_fn, kit.value_fn, kit.make_run_fn

    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    t0 = time.perf_counter()

    with_quad = quad is not None
    if with_quad:
        w = np.zeros((d, cfg.N))
        for c in range(d):
            w[c, : n[c]] = np.asarray(quad[c])
        w = jnp.asarray(w)
    else:
        w = jnp.zeros((d, cfg.N))

    if max_sweeps is None:
        max_sweeps = max_rank - 1

    if rank_chunks is not None:
        chunks = auto_chunks(max_rank) if rank_chunks == "auto" \
            else [int(x) for x in rank_chunks]
        if len(chunks) > 1 and max_sweeps >= 1:
            if init_state is not None:
                raise ValueError("rank_chunks cannot resume from init_state")
            if chunks != sorted(set(chunks)) or chunks[-1] != max_rank or chunks[0] < 2:
                raise ValueError(
                    f"rank_chunks must be increasing, >= 2, ending at "
                    f"max_rank={max_rank}; got {chunks}")
            res = _cross_chunked(fun, cfg, chunks, key, w, with_quad,
                                 accuracy, truth, max_sweeps, verbose,
                                 return_state, t0, chain=chain)
            if refine_sweeps:
                res = _apply_refine(res, fun, n, refine_sweeps, quad, truth)
                if not user_return_state:
                    res.state = None
            return res

    fast = init_state is None and not return_state
    if fast:
        from ..utils.heartbeat import heartbeat

        hb = (f"cross d={d} R={cfg.R} "
              f"{'jacobi' if cfg.jacobi else 'sequential'} sweep engine")
        # one device dispatch + one small packed transfer (see make_full_fn)
        full_fn = kit.make_full_fn(max_sweeps, with_quad, accuracy)
        with heartbeat(hb):
            solved, packed = full_fn(key, w)
        packed = np.asarray(packed)
        S = max_sweeps + 1
        vals = packed[:S]
        pmax = packed[S:2 * S]
        nev = packed[2 * S:3 * S].astype(np.int64)
        rk = packed[3 * S:3 * S + d + 1].astype(np.int64)
        off = 3 * S + d + 1
        vip_fast = packed[off: off + (d - 1) * cfg.R * 4] \
            .astype(np.int64).reshape(d - 1, cfg.R, 4)
        last_it = int(packed[-3])
        neval = int(packed[-2])
        padded = int(packed[-1])
        # the train materializes LAZILY (CrossResult.tt thunk): flows
        # that never touch res.tt (bench timing, value-only drivers) skip
        # the solved-array device->host traffic entirely.  Long chains
        # additionally fetch in ONE bulk transfer + host views: d
        # per-core device slices would be d separate dispatches.
        def tt_thunk(solved=solved, rk=rk):
            if d >= 64:
                solved_h = np.asarray(solved)
                return TT(tuple(solved_h[c, : rk[c], : n[c], : rk[c + 1]]
                                for c in range(d)))
            return TT(tuple(solved[c, : rk[c], : n[c], : rk[c + 1]]
                            for c in range(d)))

        tt = tt_thunk
        st = None
    else:
        # checkpoint/resume: restart from a saved CrossState (engine-state
        # persistence the reference lacks, SURVEY.md §5; save with
        # tt.serialize.save_state / load_state)
        from ..utils.heartbeat import heartbeat

        with heartbeat(f"cross d={d} R={cfg.R} stateful engine"):
            st = init_fn(key) if init_state is None else init_state
            run_fn = make_run_fn(max_sweeps, with_quad, accuracy)
            st, last_it, vals, pmax, nev, _ = run_fn(st, w)
        last_it = int(last_it)
        vals = np.asarray(vals)
        pmax = np.asarray(pmax)
        nev = np.asarray(nev)
        rk = np.asarray(st.rk)
        neval = int(st.neval)
        padded = int(st.padded)

    values, errors = _values_errors(vals, last_it, truth, with_quad)
    converged = accuracy is not None and last_it < max_sweeps

    from ..utils.metrics import history_from_run

    history = history_from_run(last_it, vals, pmax, nev, truth, with_quad)
    if verbose:
        for rec in history:
            line = (f"{rec.it:3d}{rec.direction} n_evals: {rec.n_evals:10d} "
                    f"pivotmax {rec.pivotmax:9.3e}")
            if rec.err is not None:
                line += f" err {rec.err:9.3e} val {rec.value:.14e}"
            elif rec.cnv is not None:
                line += f" cnv {rec.cnv:9.3e} val {rec.value:.14e}"
            print(line)

    if not fast:
        tt = finalize(st, cfg, kit)
    res = CrossResult(
        tt=tt, neval=neval, sweeps=last_it,
        ranks=tuple(int(x) for x in rk),
        values=values, errors=errors,
        time=time.perf_counter() - t0, converged=converged, history=history,
        padded_evals=padded,
    )
    if return_state:
        res.state = st
    elif return_pivots or host_reeval is not None:
        # light skeleton hookup (cross/skeleton.py): the fused fast path
        # already ships vip in its packed output, so the single-dispatch
        # executable is kept — return_state=True would fall off it
        # (per-sweep dispatches + a multi-MB state transfer)
        from types import SimpleNamespace

        res.state = (SimpleNamespace(vip=vip_fast, rk=rk) if st is None
                     else SimpleNamespace(vip=np.asarray(st.vip),
                                          rk=np.asarray(st.rk)))
    if refine_sweeps:
        seed_state = st
        if seed_state is None:
            # fast path: the pivot chains came back inside the packed
            # vector; a vip/rk shim is all pivot_index_sets needs
            from types import SimpleNamespace

            seed_state = SimpleNamespace(vip=vip_fast, rk=rk)
        res = _apply_refine(res, fun, n, refine_sweeps, quad, truth,
                            state=seed_state)
        if not user_return_state:
            res.state = None
    if host_reeval is not None:
        res = _apply_host_reeval(res, host_reeval, n, None, quad, truth)
        if not (return_state or return_pivots):
            res.state = None
    return res


def _apply_refine(res: CrossResult, fun, n, refine_sweeps, quad, truth,
                  state=None, refine_fn=None):
    """Maxvol pivot-replacement post-pass (cross(refine_sweeps=k)): seed
    the alternating-maxvol refinement (cross/maxvol.py) with the greedy
    pivot sets and swap in the refined interpolant.  Telemetry: one 'mv'
    history record per call, neval/padded_evals accumulate.

    state: the final CrossState carrying the greedy pivots (defaults to
    res.state); refine_fn: the refinement engine (defaults to the
    sequential maxvol_refine — cross_parallel passes the distributed
    one, parallel/maxvol.py, bound to its mesh)."""
    from ..utils.metrics import SweepRecord
    from .chains import pivot_index_sets
    from .maxvol import maxvol_refine

    if state is None:
        state = res.state
    if refine_fn is None:
        refine_fn = maxvol_refine
    I, J = pivot_index_sets(state.vip, state.rk)
    mv = refine_fn(fun, n, init_sets=(I, J), sweeps=int(refine_sweeps),
                   quad=quad, truth=truth)
    res.tt = mv.tt
    res.ranks = mv.ranks
    res.neval += mv.neval
    if res.padded_evals is not None and mv.padded_evals is not None:
        res.padded_evals += mv.padded_evals
    if quad is not None and mv.values:
        res.values.append(mv.values[-1])
        if truth is not None:
            res.errors.append(mv.errors[-1])
        else:
            prev = res.values[-2]
            res.errors.append(abs(1.0 - mv.values[-1] / prev)
                              if prev != 0 else float("nan"))
        if res.history is not None:
            res.history.append(SweepRecord(
                it=res.sweeps + 1, direction="mv", n_evals=res.neval,
                pivotmax=float(res.history[-1].pivotmax) if res.history else 0.0,
                value=mv.values[-1],
                err=res.errors[-1] if truth is not None else None,
                cnv=None if truth is not None else res.errors[-1]))
    return res


def _cross_chunked(fun, cfg: CrossConfig, chunks, key, w, with_quad,
                   accuracy, truth, max_sweeps, verbose, return_state, t0,
                   chain=None):
    """Chunked rank-padding growth: run the sweep loop at increasing padded
    ranks, re-embedding the state between chunks (state.pad_state).  The
    global iteration counter and the quiet-sweep strike carry across chunks
    so sweep directions and the stopping rule match the single-chunk run."""
    from .state import pad_state

    pad_jit = jax.jit(pad_state, static_argnums=1)  # one dispatch per chunk

    d = cfg.d
    # sweeps per chunk: rank grows at most 1 per sweep, so chunk c covers
    # sweeps while rank <= chunks[c]
    lens = [chunks[0] - 1] + [b - a for a, b in zip(chunks[:-1], chunks[1:])]
    total = sum(lens)
    if max_sweeps < total:       # trim the schedule to the sweep budget
        cut, acc_len = [], 0
        for Rc, lc in zip(chunks, lens):
            lc = min(lc, max_sweeps - acc_len)
            if lc <= 0:
                break
            cut.append((Rc, lc))
            acc_len += lc
        plan = cut
    else:                        # surplus sweeps extend the last chunk
        lens[-1] += max_sweeps - total
        plan = list(zip(chunks, lens))

    st = None
    it0, strike = 1, 0
    vals_parts, pmax_parts, nev_parts = [], [], []
    v0 = None
    chunk_sweeps = []
    kit_c = None
    for ci, (Rc, len_c) in enumerate(plan):
        cfg_c = dc_replace(cfg, R=Rc)
        kit_c = get_engine(fun, cfg_c, chain=chain)
        if ci == 0:
            st = kit_c.init_fn(key)
        else:
            st = pad_jit(st, Rc)
        run_fn = kit_c.make_run_fn(len_c, with_quad, accuracy)
        args = (st, w, jnp.asarray(it0, jnp.int32), jnp.asarray(strike, jnp.int32))
        st, t_last, vals, pmax, nev, strike = run_fn(*args)
        t_last = int(t_last)
        strike = int(strike)
        vals = np.asarray(vals)
        if ci == 0:
            v0 = vals[0]
        vals_parts.append(vals[1: t_last + 1])
        pmax_parts.append(np.asarray(pmax)[1: t_last + 1])
        nev_parts.append(np.asarray(nev)[1: t_last + 1])
        chunk_sweeps.append((Rc, t_last))
        it0 += t_last
        if t_last < len_c or (accuracy is not None and strike >= 3):
            break

    last_it = it0 - 1
    vals = np.concatenate([[v0]] + vals_parts) if with_quad else \
        np.zeros(last_it + 1)
    pmax = np.concatenate([[0.0]] + pmax_parts)
    nev = np.concatenate([[0]] + nev_parts).astype(np.int64)
    rk = np.asarray(st.rk)
    neval = int(st.neval)
    padded = int(st.padded)

    values, errors = _values_errors(vals, last_it, truth, with_quad)
    converged = accuracy is not None and strike >= 3

    from ..utils.metrics import history_from_run

    history = history_from_run(last_it, vals, pmax, nev, truth, with_quad)
    if verbose:
        for rec in history:
            line = (f"{rec.it:3d}{rec.direction} n_evals: {rec.n_evals:10d} "
                    f"pivotmax {rec.pivotmax:9.3e}")
            if rec.err is not None:
                line += f" err {rec.err:9.3e} val {rec.value:.14e}"
            elif rec.cnv is not None:
                line += f" cnv {rec.cnv:9.3e} val {rec.value:.14e}"
            print(line)

    cfg_last = dc_replace(cfg, R=chunk_sweeps[-1][0])
    tt = finalize(st, cfg_last, kit_c)
    res = CrossResult(
        tt=tt, neval=neval, sweeps=last_it,
        ranks=tuple(int(x) for x in rk),
        values=values, errors=errors,
        time=time.perf_counter() - t0, converged=converged, history=history,
        padded_evals=padded,
    )
    if return_state:
        res.state = st
    return res
