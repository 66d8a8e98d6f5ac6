"""Quad-double DMRG-greedy cross engine (vectorized ~62-digit host tier).

Mirror of the arbitrary-precision engine (engine_mp.py — the mptt_dmrgg
analogue, dmrggmp.f90:11-704) with every value — fibers, factors,
residuals, the bordered triangular inverses, the per-sweep quadrature —
a four-limb qd number (ops/qd.py) instead of an mpmath mpf.  The payoff
is THROUGHPUT: mpmath works scalar-by-scalar in Python, while the qd
representation is a struct-of-arrays of f64 limbs, so every fiber/factor
operation here is a short chain of vectorized numpy ufuncs (error-free
transforms at C speed).  At C_4 scale this engine crosses in seconds
where cross_mp at a comparable dps takes minutes, and it reaches ~60
correct digits at LOW rank — where the f64-engine defect pipeline
(cross/defect.py) needs near-full correction ranks because an f64
train's defect is noise-like.

Like the reference's MPFUN tier (and cross_mp) this path is host/CPU
only (see ops/qd.py).  The tier ladder is
  f64 engine (device)   ~13 digits
  dd engine  (device)   ~31 digits     cross/engine_dd.py
  qd engine  (host)     ~60 digits     THIS MODULE
  mp engine  (host)    ~120 digits     cross/engine_mp.py

Reference-fidelity notes (all inherited from the mp mirror):
  * thresholds and amax live in the log10 domain (dmrggmp.f90:50-53,
    107, 364): small_element defaults to -QD_DPS + 2, small_pivot -7;
  * a per-iteration quadrature value and err/cnv line is produced
    (dmrggmp.f90:655-672);
  * ragged host arrays grow rank-by-rank like the Fortran
    reallocate-on-accept pattern;
  * the hunt is rook pivoting (lottery seed + alternating column/row
    maximization with stationarity exit, dmrgg.f90:410-582).
Selection decisions (argmax, thresholds) compare leading limbs — f64
*resolution* is ample once the *values* carry ~62 digits (the same
license as the dd engine, engine_dd.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from ..ops.qd import (QD, qd, qd_concat, qd_div, qd_get, qd_mag10,
                      qd_matmul, qd_mul, qd_neg, qd_sub, qd_sum, qd_to_mp,
                      qd_tt_value, qd_vdot_axis, qd_zeros)
from .hostwalk import walk_index as _walk_index

__all__ = ["cross_qd", "QdCrossResult", "QdEngine", "QD_DPS"]

QD_DPS = 62   # four f64 limbs carry ~4*53 bits ~ 63.8 decimal digits


@dataclass
class QdCrossResult:
    cores: list              # solved ragged QD arrays (r, n, r')
    value: QD | None         # qd quadrature value (None without quad)
    neval: int
    sweeps: int
    ranks: tuple
    history: list            # per-sweep dicts {it, dir, pivotmax_log10, value, err}


def _np_qd(x) -> QD:
    """Coerce a QD (possibly jax-backed) / (n, 4) limb array / plain f64
    array to a numpy-backed QD."""
    if isinstance(x, QD):
        return QD(*(np.asarray(e, np.float64) for e in x))
    a = np.asarray(x)
    if a.ndim == 2 and a.shape[1] == 4:
        return QD(*(np.ascontiguousarray(a[:, i], np.float64) for i in range(4)))
    return qd(np.asarray(a, np.float64))


def _expand(x: QD, pos: int) -> QD:
    """Limb-wise expand_dims."""
    return QD(*(np.expand_dims(e, pos) for e in x))


def _value_chain_qd(G, itl, itt, w, d) -> QD:
    """LU-solved quadrature contraction: prod_c itl[c-1] (sum_j G_c w_cj)
    itt[c] (ttqq + mptt_lua + mptt_quad, dmrggmp.f90:640-672)."""
    v = None
    for c in range(d):
        M = qd_vdot_axis(G[c], qd_get(w[c], slice(0, G[c].e0.shape[1])), 1)
        if c > 0:
            M = qd_matmul(itl[c - 1], M)
        if c < d - 1:
            M = qd_matmul(M, itt[c])
        v = M if v is None else qd_matmul(v, M)
    return qd_get(v, (0, 0))


class QdEngine:
    """Host-side qd cross state + bond-visit machinery (the QD sibling of
    MpEngine, cross/engine_mp.py:93-348 — same ragged state layout, same
    visit/accept/replay protocol, SoA limb arrays instead of object
    arrays)."""

    def __init__(self, fun_qd, n, max_rank, pivoting,
                 small_element_log10, small_pivot_log10, snum, seed):
        self.fun_qd = fun_qd
        self.n = tuple(int(x) for x in n)
        self.d = len(self.n)
        self.max_rank = int(max_rank)
        self.piv = max(int(pivoting), 0)
        self.lse = (small_element_log10 if small_element_log10 is not None
                    else -QD_DPS + 2)
        self.lsp = small_pivot_log10
        self.snum = snum
        self.rng = np.random.default_rng(seed)
        self.neval = 0
        self.own_cores = None    # distributed hook, like MpEngine

    def _eval(self, ind) -> QD:
        v = self.fun_qd(np.asarray(ind, np.int64))
        self.neval += len(ind)
        return _np_qd(v)

    # ------------------------------------------------ initial pivot search
    def init_state(self):
        """Shifted-diagonal search + rank-1 cross (dmrgg.f90:151-248)."""
        n, d = self.n, self.d
        nn = min(n)
        cand = np.zeros((self.snum * nn, d), dtype=np.int64)
        for s in range(self.snum):
            for k in range(nn):
                cand[s * nn + k] = [(k + s * p) % n[p] for p in range(d)]
        vals = self._eval(cand)
        best = int(np.argmax(np.abs(vals.e0)))
        self.log_amax = float(qd_mag10(qd_get(vals, best)))
        ind0 = cand[best]

        self.vip = [[(0, int(ind0[b]), int(ind0[b + 1]), 0)]
                    for b in range(d - 1)]
        self.r = [1] * (d + 1)

        self.G = []
        for c in range(d):
            fib = np.tile(ind0, (n[c], 1))
            fib[:, c] = np.arange(n[c])
            fv = self._eval(fib)
            self.log_amax = max(self.log_amax, float(np.max(qd_mag10(fv))))
            self.G.append(QD(*(e.reshape(1, n[c], 1) for e in fv)))
        delta = qd_get(self.G[0], (0, int(ind0[0]), 0))
        self.Cf = [qd_div(self.G[b], delta) for b in range(d - 1)]
        self.Rf = [QD(*(e.copy() for e in self.G[b + 1])) for b in range(d - 1)]
        self.itl = [qd(np.ones((1, 1))) for _ in range(d - 1)]
        self.itt = [qd_div(qd(np.ones((1, 1))), delta) for _ in range(d - 1)]
        self.log_pivotmax_prev = self.log_amax

    # ------------------------------------------------------- fiber batches
    def eval_col(self, b, kk, qq) -> QD:
        """Raw column fiber (r[b], n[b]) at fixed (kk, qq)."""
        r, n, vip, d = self.r, self.n, self.vip, self.d
        idx = np.array([_walk_index(vip, b, d, i, j, kk, qq)
                        for i in range(r[b]) for j in range(n[b])],
                       dtype=np.int64)
        v = self._eval(idx)
        return QD(*(e.reshape(r[b], n[b]) for e in v))

    def eval_row(self, b, ii, jj) -> QD:
        r, n, vip, d = self.r, self.n, self.vip, self.d
        idx = np.array([_walk_index(vip, b, d, ii, jj, k, q)
                        for k in range(n[b + 1]) for q in range(r[b + 2])],
                       dtype=np.int64)
        v = self._eval(idx)
        return QD(*(e.reshape(n[b + 1], r[b + 2]) for e in v))

    @staticmethod
    def _argmax_abs(a: QD):
        return np.unravel_index(int(np.argmax(np.abs(a.e0))), a.e0.shape)

    # --------------------------------------------------------- bond visit
    def visit_bond(self, b, dir_fwd):
        """Hunt + (maybe) accept at owned bond b.  Returns a tape record
        (dict) when a pivot was accepted, else None — the same record
        schema as MpEngine.visit_bond with QD payloads."""
        r, n, vip, d = self.r, self.n, self.vip, self.d
        Cf, Rf = self.Cf, self.Rf
        piv = self.piv
        used_c = {(pv[0], pv[1]) for pv in vip[b]}
        used_r = {(pv[2], pv[3]) for pv in vip[b]}
        all_c = [(i, j) for i in range(r[b]) for j in range(n[b])
                 if (i, j) not in used_c]
        all_r = [(k, q) for k in range(n[b + 1]) for q in range(r[b + 2])
                 if (k, q) not in used_r]
        if not all_c or not all_r:
            return None
        nlot = r[b] + n[b] + n[b + 1] + r[b + 2]
        sel_c = np.array([all_c[i] for i in
                          self.rng.integers(0, len(all_c), nlot)])
        sel_r = np.array([all_r[i] for i in
                          self.rng.integers(0, len(all_r), nlot)])
        idx = np.array([_walk_index(vip, b, d, i, j, k, q)
                        for (i, j), (k, q) in zip(sel_c, sel_r)],
                       dtype=np.int64)
        bvals = self._eval(idx)
        self.log_amax = max(self.log_amax, float(np.max(qd_mag10(bvals))))
        cf = qd_get(Cf[b], (sel_c[:, 0], sel_c[:, 1], slice(None)))  # (B, R)
        rf = QD(*(e[:, sel_r[:, 0], sel_r[:, 1]].T for e in Rf[b]))  # (B, R)
        resid = qd_sub(bvals, qd_sum(qd_mul(cf, rf), axis=1))
        bi = int(np.argmax(np.abs(resid.e0)))
        (ii, jj), (kk, qq) = sel_c[bi], sel_r[bi]
        ii, jj, kk, qq = int(ii), int(jj), int(kk), int(qq)
        pivot = qd_get(resid, bi)

        # rook passes (dmrgg.f90:515-582)
        acol = arow = None
        havecol = haverow = False
        crs = 0
        skipcol = not dir_fwd
        done = piv == 0
        if piv == 0:
            acol = self.eval_col(b, kk, qq)
            arow = self.eval_row(b, ii, jj)
            havecol = haverow = True
        while not done:
            if not skipcol:
                acol = self.eval_col(b, kk, qq)
                havecol = True
                crs += 1
                if not (havecol and haverow and crs >= 2 * piv):
                    u = qd_get(Rf[b], (slice(None), kk, qq))
                    bcol = qd_sub(acol, qd_vdot_axis(Cf[b], u, 2))
                    i2, j2 = self._argmax_abs(bcol)
                    stat = havecol and haverow and (i2, j2) == (ii, jj)
                    ii, jj = int(i2), int(j2)
                    pivot = qd_get(bcol, (i2, j2))
                    if stat:
                        break
                else:
                    break
            skipcol = False
            arow = self.eval_row(b, ii, jj)
            haverow = True
            crs += 1
            if not (havecol and haverow and crs >= 2 * piv):
                c = qd_get(Cf[b], (ii, jj, slice(None)))
                brow = qd_sub(arow, qd_vdot_axis(Rf[b], c, 0))
                k2, q2 = self._argmax_abs(brow)
                stat = havecol and haverow and (k2, q2) == (kk, qq)
                kk, qq = int(k2), int(q2)
                pivot = qd_get(brow, (k2, q2))
                if stat:
                    break
            else:
                break
        if not havecol:
            acol = self.eval_col(b, kk, qq)
        if not haverow:
            arow = self.eval_row(b, ii, jj)
        self.log_amax = max(self.log_amax, float(np.max(qd_mag10(acol))),
                            float(np.max(qd_mag10(arow))))

        # two-threshold accept, log domain (dmrggmp.f90:364)
        lp = float(qd_mag10(pivot))
        if not (lp > self.lse + self.log_amax
                and lp > self.lsp + self.log_pivotmax_prev
                and r[b + 1] < self.max_rank):
            return None
        c_new = qd_get(Cf[b], (ii, jj, slice(None)))
        u_new = qd_get(Rf[b], (slice(None), kk, qq))
        self._accept_owner(b, ii, jj, kk, qq, pivot, acol, arow,
                           c_new, u_new)
        return {"b": b, "ijkq": (ii, jj, kk, qq), "pivot": pivot,
                "c_new": c_new, "u_new": u_new, "acol": acol, "arow": arow,
                "lp": lp}

    def _accept_owner(self, b, ii, jj, kk, qq, pivot, acol, arow,
                      c_new, u_new):
        """Owner-side accept: extend vip / cores / factors / inverses
        (MpEngine._accept_owner mirror)."""
        self.vip[b].append((int(ii), int(jj), int(kk), int(qq)))
        if self.own_cores is None or b in self.own_cores:
            self.G[b] = qd_concat([self.G[b], _expand(acol, 2)], axis=2)
        if self.own_cores is None or (b + 1) in self.own_cores:
            self.G[b + 1] = qd_concat([self.G[b + 1], _expand(arow, 0)],
                                      axis=0)
        new_colf = qd_div(qd_sub(acol, qd_vdot_axis(self.Cf[b], u_new, 2)),
                          pivot)
        self.Cf[b] = qd_concat([self.Cf[b], _expand(new_colf, 2)], axis=2)
        new_rowf = qd_sub(arow, qd_vdot_axis(self.Rf[b], c_new, 0))
        self.Rf[b] = qd_concat([self.Rf[b], _expand(new_rowf, 0)], axis=0)
        self._extend_inverses(b, pivot, c_new, u_new)
        self.r[b + 1] += 1

    def _extend_inverses(self, b, pivot, c_new, u_new):
        """Bordered triangular inverse growth (MpEngine._extend_inverses
        mirror; replicated on every worker in a distributed mode)."""
        s = self.itl[b].e0.shape[0]
        row_new = qd_concat([qd_neg(qd_vdot_axis(self.itl[b], c_new, 0)),
                             qd(np.ones(1))])
        self.itl[b] = qd_concat(
            [qd_concat([self.itl[b], qd_zeros((s, 1))], axis=1),
             _expand(row_new, 0)], axis=0)
        col_new = qd_concat([qd_div(qd_neg(qd_vdot_axis(self.itt[b], u_new, 1)),
                                    pivot),
                             qd_div(qd(np.ones(1)), pivot)])
        top = qd_concat([self.itt[b],
                         _expand(qd_get(col_new, slice(0, s)), 1)], axis=1)
        bot = qd_concat([qd_zeros((1, s)),
                         _expand(qd_get(col_new, slice(s, s + 1)), 1)], axis=1)
        self.itt[b] = qd_concat([top, bot], axis=0)

    def replay_remote(self, rec):
        """Replay a remote worker's accept at non-owned bond b: vip / rank
        / inverses only (MpEngine.replay_remote mirror)."""
        b = rec["b"]
        self.vip[b].append(tuple(int(x) for x in rec["ijkq"]))
        self._extend_inverses(b, rec["pivot"], rec["c_new"], rec["u_new"])
        self.r[b + 1] += 1

    def apply_left_slice(self, b, acol):
        """Rf[b-1] gains the L-solved new column of bond b
        (dmrgg.f90:715-728)."""
        slc = qd_matmul(self.itl[b - 1], acol)
        self.Rf[b - 1] = qd_concat([self.Rf[b - 1], _expand(slc, 2)], axis=2)

    def apply_right_slice(self, b, arow):
        """Cf[b+1] gains the T-solved new row of bond b
        (dmrgg.f90:730-749)."""
        slc = qd_matmul(arow, self.itt[b + 1])
        self.Cf[b + 1] = qd_concat([self.Cf[b + 1], _expand(slc, 0)], axis=0)

    def solve_core(self, c):
        """mptt_lua for one core (dmrggmp.f90:720-776)."""
        g = self.G[c]
        r1, nc, r2 = g.e0.shape
        if c > 0:
            m = qd_matmul(self.itl[c - 1], QD(*(e.reshape(r1, nc * r2)
                                                for e in g)))
            g = QD(*(e.reshape(r1, nc, r2) for e in m))
        if c < self.d - 1:
            m = qd_matmul(QD(*(e.reshape(r1 * nc, r2) for e in g)),
                          self.itt[c])
            g = QD(*(e.reshape(r1, nc, r2) for e in m))
        return g


def cross_qd(
    fun_qd: Callable,
    n: Sequence[int],
    max_rank: int = 24,
    pivoting: int = 1,
    quad: Sequence | None = None,
    truth=None,
    accuracy_log10: float | None = None,
    small_element_log10: float | None = None,
    small_pivot_log10: float = -7.0,
    snum: int = 8,
    seed: int = 0,
    verbose: bool = False,
) -> QdCrossResult:
    """Quad-double TT-cross (the ~62-digit point on the mptt_dmrgg tier
    ladder, dmrggmp.f90:11-704 — see the module docstring).

    fun_qd: batched integrand ind (B, d) int numpy -> QD (B,) (a numpy
    or jax-backed QD; e.g. apps.ising.make_ising_qd's fun).  quad:
    per-mode weight vectors — each a QD, an (n_c, 4) limb array, or a
    plain f64 array.  truth: optional mpf/str for per-sweep err
    reporting.  Thresholds are log10-domain: small_element defaults to
    -QD_DPS + 2 (dmrggmp.f90:50)."""
    from mpmath import mp, mpf, workdps

    n = tuple(int(x) for x in n)
    d = len(n)
    if d < 2:
        raise ValueError("cross_qd requires d >= 2")
    lacc = accuracy_log10 if accuracy_log10 is not None else -QD_DPS + 4

    eng = QdEngine(fun_qd, n, max_rank, pivoting,
                   small_element_log10, small_pivot_log10, snum, seed)
    eng.init_state()

    w = [_np_qd(quad[c]) for c in range(d)] if quad is not None else None

    history = []
    strike = 0
    it = 0
    while it + 1 < max_rank:
        it += 1
        dir_fwd = it % 2 == 1
        bonds = range(d - 1) if dir_fwd else range(d - 2, -1, -1)
        log_pivotmax = None
        for b in bonds:
            rec = eng.visit_bond(b, dir_fwd)
            if rec is None:
                continue
            log_pivotmax = (rec["lp"] if log_pivotmax is None
                            else max(log_pivotmax, rec["lp"]))
            if b > 0:
                eng.apply_left_slice(b, rec["acol"])
            if b < d - 2:
                eng.apply_right_slice(b, rec["arow"])

        # per-iteration value / telemetry (dmrggmp.f90:655-672)
        rec = {"it": it, "dir": ">>" if dir_fwd else "<<",
               "pivotmax_log10": log_pivotmax, "n_evals": eng.neval,
               "value": None, "err": None}
        if w is not None:
            val = _value_chain_qd(eng.G, eng.itl, eng.itt, w, d)
            rec["value"] = val
            if truth is not None:
                with workdps(QD_DPS + 15):
                    rec["err"] = abs(1 - qd_to_mp(*(np.asarray(e) for e in val))
                                     / mpf(truth))
        history.append(rec)
        if verbose:
            line = (f"{it:3d}{rec['dir']} qd n_evals {eng.neval:9d} "
                    f"log10|pivot| "
                    f"{log_pivotmax if log_pivotmax is not None else float('-inf'):8.2f}")
            if rec["err"] is not None:
                with workdps(QD_DPS + 15):
                    line += (f" err {mp.nstr(rec['err'], 5)} "
                             f"val {mp.nstr(qd_to_mp(*(np.asarray(e) for e in rec['value'])), 40)}")
            print(line)

        if log_pivotmax is not None:
            eng.log_pivotmax_prev = log_pivotmax
        quiet = log_pivotmax is None or log_pivotmax <= lacc + eng.log_amax
        strike = strike + 1 if quiet else 0
        if strike >= 3:
            break

    solved = [eng.solve_core(c) for c in range(d)]
    value = qd_tt_value(solved, w) if w is not None else None
    return QdCrossResult(cores=solved, value=value, neval=eng.neval,
                         sweeps=it, ranks=tuple(eng.r), history=history)
