"""Distributed DMRG-greedy cross over a 1-D 'bond' device mesh.

JAX re-architecture of the reference's MPI dimension-parallel runtime
(dmrgg.f90:120-131, 763-958; SURVEY.md §2.5).  Each device owns a contiguous
bond slab and runs the same local sweep as the single-chip engine; global
consistency is restored once per iteration with XLA collectives instead of
MPI point-to-point:

  reference (MPI)                           here (shard_map collectives)
  ------------------------------------      ---------------------------------
  4-int pivot tape, 1-hop sendrecv          psum of disjoint per-bond tape
    (multi-hop staleness, dmrgg.f90:768)      rows -> ZERO staleness, and the
                                              tape carries the LU border row
                                              so every device replays vip +
                                              rk + growing-LU exactly
  boundary core-slice ship left only        each device re-evaluates the two
    (+ corner eval, dmrgg.f90:872-958;        boundary fibers it needs; this
    the double engine never backfills         also backfills the col factor
    the right side)                           the reference leaves stale
  3-scalar MPI_ALLREDUCE(MAX)               lax.pmax / pmin
  binary-tree pairwise dgemm reduce         per-device chain-product of LU-
    (dtt_quad, dmrgg.f90:1356-1405)           solved (R, R) mats, all_gather,
                                              ordered product (replicated)
  inv sendrecv in dtt_lua                   not needed: LU is replicated via
    (dmrgg.f90:1209-1246)                     the extended tape

State is carried with a leading device axis sharded over the mesh; cores and
factors are owner-authoritative (like the reference), while vip / ranks / LU
are kept exactly consistent on every device.  The whole multi-sweep run,
including the stopping rule, is ONE shard_map'd device call.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import precision_thresholds
from ..ops import lu as lulib
from ..cross.chains import (advance_left, advance_right, all_left_tables,
                            all_right_tables, left_table, right_table)
from ..cross.engine import CrossConfig, CrossResult, EngineKit, finalize, get_engine
from ..cross.state import CrossState
from .mesh import BOND_AXIS, bond_mesh, share

__all__ = ["cross_parallel", "make_parallel_engine"]

_PAR_CACHE: dict = {}
_PAR_PINS: list = []


def _lu_at(st: CrossState, b) -> lulib.GrowingLU:
    return lulib.GrowingLU(
        c=jax.lax.dynamic_index_in_dim(st.lu_c, b, 0, keepdims=False),
        u=jax.lax.dynamic_index_in_dim(st.lu_u, b, 0, keepdims=False),
        d=jax.lax.dynamic_index_in_dim(st.lu_d, b, 0, keepdims=False),
    )


def _at(arr, c):
    return jax.lax.dynamic_index_in_dim(arr, c, 0, keepdims=False)


def get_parallel_engine(fun: Callable, cfg: CrossConfig, mesh: Mesh,
                        mybonds=None, chain=None):
    target = getattr(fun, "__self__", fun)
    mb = None if mybonds is None else tuple(int(x) for x in mybonds)
    key = (id(target), getattr(fun, "__name__", None), cfg, id(mesh), mb,
           None if chain is None else id(chain))
    eng = _PAR_CACHE.get(key)
    if eng is None:
        _PAR_PINS.append((target, mesh, chain))
        eng = _PAR_CACHE[key] = make_parallel_engine(fun, cfg, mesh, mybonds,
                                                     chain=chain)
    return eng


def make_parallel_engine(fun: Callable, cfg: CrossConfig, mesh: Mesh,
                         mybonds=None, chain=None):
    """Build the distributed runner.  Returns (init_fn, make_run_fn,
    gather_fn) where run/gather are shard_map'd over the mesh.

    mybonds: optional caller-provided slab boundaries (ndev+1,), replacing
    the block `share` distribution (the reference's `mybonds` argument,
    dmrgg.f90:22, 120-131)."""
    kit: EngineKit = get_engine(fun, cfg, chain=chain)
    d, N, R = cfg.d, cfg.N, cfg.R
    ndev = mesh.devices.size
    if mybonds is None:
        own = share(d - 1, ndev)                   # (ndev+1,)
    else:
        own = np.asarray(mybonds, dtype=np.int32)
        if (own.shape != (ndev + 1,) or own[0] != 0 or own[-1] != d - 1
                or np.any(np.diff(own) < 1)):
            raise ValueError(
                f"mybonds must be {ndev + 1} increasing slab boundaries "
                f"from 0 to {d - 1} with at least one bond per device; "
                f"got {own.tolist()}")
    own_lo_tbl = jnp.asarray(own[:-1], jnp.int32)  # per-device slab start
    own_hi_tbl = jnp.asarray(own[1:], jnp.int32)   # one-past-last bond
    max_cnt = int(np.max(own[1:] - own[:-1]))
    max_cores = int(np.max((own[1:] - own[:-1]) + (np.arange(ndev) == ndev - 1)))
    n_arr = jnp.asarray(cfg.n, jnp.int32)
    iR = jnp.arange(R)
    init_padded = cfg.snum * int(min(cfg.n)) + d * N

    def my_bounds():
        me = jax.lax.axis_index(BOND_AXIS)
        return me, own_lo_tbl[me], own_hi_tbl[me]

    # -------------------------------------------------------------- sweep
    def make_local_sweep(fwd: bool):
        """Sequential hunt over the owned slab in a STATIC direction,
        recording the tape (the per-sweep dispatch conds on the parity, so
        each body compiles with only its own rook pass order — see
        engine._rook)."""

        def local_sweep(st: CrossState, own_lo, own_hi):
            cnt = own_hi - own_lo
            key, sub = jax.random.split(st.key)
            U = jax.random.uniform(sub, (d - 1, 2, 2 * (R + N)), jnp.float64)
            st = st._replace(pivotmax=jnp.full((), -1.0, st.amax.dtype),
                             pivotmin=jnp.full((), -1.0, st.amax.dtype),
                             key=key)
            tape_i = jnp.zeros((d - 1, 5), jnp.int32)
            tape_f = jnp.zeros((d - 1, 2 * R + 1), st.amax.dtype)
            AT = (all_right_tables(st.vip, d) if fwd
                  else all_left_tables(st.vip, d))
            first = (own_lo if fwd else own_hi - 1).astype(jnp.int32)
            # the table we advance INTO starts at the slab edge: LT[own_lo]
            # for '>>' ( = advance of LT up to own_lo), RT[own_hi-1] for '<<'
            tab0 = (left_table(st.vip, first, d) if fwd
                    else right_table(st.vip, first, d))

            def body(idx, carry):
                st, ti, tf, tab = carry
                off = idx if fwd else cnt - 1 - idx
                p = (own_lo + jnp.clip(off, 0, jnp.maximum(cnt - 1, 0))).astype(jnp.int32)
                valid = idx < cnt

                def do(args):
                    st, ti, tf, tab = args
                    ltab = tab if fwd else _at(AT, p)
                    rtab = _at(AT, p) if fwd else tab
                    st2, row_i, row_f = kit.visit_bond(st, p, fwd, own_lo, own_hi,
                                                       ltab=ltab, rtab=rtab, u2=_at(U, p))
                    ti = jax.lax.dynamic_update_slice(ti, row_i[None], (p, jnp.int32(0)))
                    tf = jax.lax.dynamic_update_slice(tf, row_f[None], (p, jnp.int32(0)))
                    vip_p = _at(st2.vip, p)
                    tab = (advance_left(tab, vip_p, p) if fwd
                           else advance_right(tab, vip_p, p - 1))
                    return st2, ti, tf, tab

                return jax.lax.cond(valid, do, lambda a: a, (st, ti, tf, tab))

            st, tape_i, tape_f, _ = jax.lax.fori_loop(0, max_cnt, body,
                                                      (st, tape_i, tape_f, tab0))
            return st, tape_i, tape_f

        return local_sweep

    _local_sweep = {True: make_local_sweep(True), False: make_local_sweep(False)}

    def replay(st: CrossState, TI, TF, own_lo, own_hi):
        """Apply every other device's accepted pivots to vip / rk / LU
        (the tape replay of dmrgg.f90:822-850, extended to the LU so the
        growing-LU is exactly replicated)."""

        def body(b, st):
            owned = (b >= own_lo) & (b < own_hi)
            acc = TI[b, 0] > 0

            def app(st):
                bz = jnp.asarray(b, jnp.int32)
                z = jnp.int32(0)
                s = st.rk[b + 1].astype(jnp.int32)
                c_new = TF[b, :R]
                u_new = TF[b, R:2 * R]
                pivot = TF[b, 2 * R]
                vip = jax.lax.dynamic_update_slice(st.vip, TI[b, 1:5][None, None, :], (bz, s, z))
                lu_c = jax.lax.dynamic_update_slice(st.lu_c, c_new[None, None, :], (bz, s, z))
                lu_u = jax.lax.dynamic_update_slice(st.lu_u, u_new[None, None, :], (bz, s, z))
                lu_d = jax.lax.dynamic_update_slice(st.lu_d, pivot[None, None], (bz, s))
                # replay the maintained inverse recurrences too
                itl_b = _at(st.itl, bz)
                new_row = jnp.where(iR == s, 1.0, -(c_new @ itl_b))
                itl_b = jax.lax.dynamic_update_slice(itl_b, new_row[None, :], (s, z))
                itl = jax.lax.dynamic_update_slice(st.itl, itl_b[None], (bz, z, z))
                itt_b = _at(st.itt, bz)
                new_col = jnp.where(iR == s, 1.0 / pivot, -(itt_b @ u_new) / pivot)
                itt_b = jax.lax.dynamic_update_slice(itt_b, new_col[:, None], (z, s))
                itt = jax.lax.dynamic_update_slice(st.itt, itt_b[None], (bz, z, z))
                apiv = jnp.abs(pivot)
                pivotmax = jnp.where(st.pivotmax < 0, apiv, jnp.maximum(st.pivotmax, apiv))
                pivotmin = jnp.where(st.pivotmin < 0, apiv, jnp.minimum(st.pivotmin, apiv))
                return st._replace(vip=vip, lu_c=lu_c, lu_u=lu_u, lu_d=lu_d,
                                   itl=itl, itt=itt,
                                   rk=st.rk.at[b + 1].add(1),
                                   pivotmax=pivotmax, pivotmin=pivotmin)

            return jax.lax.cond(acc & ~owned, app, lambda s: s, st)

        return jax.lax.fori_loop(0, d - 1, body, st)

    def fixup(st: CrossState, TI, own_lo, own_hi):
        """Boundary repairs after replay (replaces the reference's block
        ship + corner evaluation, dmrgg.f90:872-958).

        Right edge: the right neighbour's first bond (own_hi) accepted a new
        column -> re-evaluate that raw fiber (it now includes the corner row
        from our own last-bond accept) and extend our row factor of bond
        own_hi-1 with the L-solved slice (dmrgg.f90:940-951).

        Left edge: the left neighbour's last bond (own_lo-1) accepted a new
        row -> re-evaluate the raw row fiber, store it into our
        authoritative core own_lo, and backfill our col factor of bond
        own_lo with the T-solved slice (the update the reference's double
        engine skips across ranks)."""
        z = jnp.int32(0)

        bR = jnp.clip(own_hi, 0, d - 2).astype(jnp.int32)
        do_r = (own_hi <= d - 2) & (TI[bR, 0] > 0)

        def fix_right(st):
            kk, qq = TI[bR, 3], TI[bR, 4]
            ltab = left_table(st.vip, bR, d)
            rtab = right_table(st.vip, bR, d)
            fiber, amax, neval, padded = kit.eval_col_fiber(st, bR, ltab, rtab, kk, qq)
            st = st._replace(amax=amax, neval=neval, padded=padded)
            slc = _at(st.itl, jnp.maximum(bR - 1, 0)) @ fiber
            s = (st.rk[bR + 1] - 1).astype(jnp.int32)
            rowf_b = jax.lax.dynamic_update_slice(_at(st.rowf, bR), slc[:, :, None], (z, z, s))
            rowf = jax.lax.dynamic_update_slice(st.rowf, rowf_b[None], (bR, z, z, z))
            return st._replace(rowf=rowf)

        st = jax.lax.cond(do_r, fix_right, lambda s: s, st)

        bL = jnp.clip(own_lo - 1, 0, d - 2).astype(jnp.int32)
        do_l = (own_lo >= 1) & (TI[bL, 0] > 0)

        def fix_left(st):
            ii, jj = TI[bL, 1], TI[bL, 2]
            ltab = left_table(st.vip, bL, d)
            rtab = right_table(st.vip, bL, d)
            fiber, amax, neval, padded = kit.eval_row_fiber(st, bL, ltab, rtab, ii, jj)  # (N, R)
            st = st._replace(amax=amax, neval=neval, padded=padded)
            c0 = (bL + 1).astype(jnp.int32)           # = own_lo
            s = (st.rk[c0] - 1).astype(jnp.int32)
            cores_c = jax.lax.dynamic_update_slice(_at(st.cores, c0), fiber[None], (s, z, z))
            cores = jax.lax.dynamic_update_slice(st.cores, cores_c[None], (c0, z, z, z))
            slc = fiber @ _at(st.itt, c0)
            colf_c = jax.lax.dynamic_update_slice(_at(st.colf, c0), slc[None], (s, z, z))
            colf = jax.lax.dynamic_update_slice(st.colf, colf_c[None], (c0, z, z, z))
            return st._replace(cores=cores, colf=colf)

        return jax.lax.cond(do_l, fix_left, lambda s: s, st)

    def _scalar_fold(st: CrossState):
        """Per-sweep scalar reductions in ONE gather: max(amax),
        max(pivotmax), min(pivotmin), sum(neval), sum(padded) — one
        all_gather in place of separate pmax/pmin/psum reductions.  The int64 counter deltas ride the gather as f64 (exact
        to 2^53 — NOT the state dtype: an f32 payload would round per-run
        deltas past 2^24, which long-chain jacobi runs reach)."""
        dt = st.amax.dtype
        f64 = jnp.float64
        sc = jnp.stack([
            st.amax.astype(f64), st.pivotmax.astype(f64),
            jnp.where(st.pivotmin < 0, jnp.inf, st.pivotmin).astype(f64),
            (st.neval - kit.init_neval).astype(f64),
            (st.padded - init_padded).astype(f64),
        ])
        G = jax.lax.all_gather(sc, BOND_AXIS)       # (ndev, 5)
        pmin = jnp.min(G[:, 2])
        st = st._replace(
            amax=jnp.max(G[:, 0]).astype(dt),
            pivotmax=jnp.max(G[:, 1]).astype(dt),
            pivotmin=jnp.where(jnp.isinf(pmin), -1.0, pmin).astype(dt),
            pivotmax_prev=jnp.max(G[:, 1]).astype(dt))
        nev_tot = jnp.sum(G[:, 3]).astype(jnp.int64) + kit.init_neval
        padded_tot = jnp.sum(G[:, 4]).astype(jnp.int64) + init_padded
        return st, nev_tot, padded_tot

    def psweep(st: CrossState, it, own_lo, own_hi):
        """One distributed sweep with the per-iteration traffic packed into
        TWO collectives (the reference pays 2 sendrecv chains + 3 scalar
        allreduces + a per-sweep MPI_SUM; an earlier rendering here paid 2
        psums + 3 all_gathers + 1 psum): one psum of the concatenated
        int+float tape rows (disjoint per bond, and int32 values are exact
        in f64), and one all_gather of a 5-scalar vector carrying the
        max/min/sum reductions together."""
        dt = st.amax.dtype
        st, tape_i, tape_f = jax.lax.cond(
            (it % 2) == 1,
            lambda a: _local_sweep[True](*a),
            lambda a: _local_sweep[False](*a),
            (st, own_lo, own_hi))
        payload = jnp.concatenate([tape_f, tape_i.astype(dt)], axis=1)
        TP = jax.lax.psum(payload, BOND_AXIS)       # (d-1, 2R+6)
        TF = TP[:, : 2 * R + 1]
        TI = jnp.round(TP[:, 2 * R + 1:]).astype(jnp.int32)
        st = replay(st, TI, TF, own_lo, own_hi)
        st = fixup(st, TI, own_lo, own_hi)
        return _scalar_fold(st)

    def psweep_jacobi(st: CrossState, it, own_lo, own_hi):
        """One distributed slab-level Jacobi sweep: each device runs the
        batched lottery+rook hunt over ITS OWN bond slab (engine
        jacobi_hunt with a clamped mc-wide window), the per-bond results
        are merged with ONE psum (disjoint live masks; an extra payload
        row carries each device's amax in its own slot, making the psum
        double as an all_gather for the max), and every device then runs
        the SAME deterministic batched acceptance + corner repair +
        reconstruction (engine jacobi_apply) — so the whole state stays
        exactly replicated and no boundary fixup or tape replay is needed.
        The distributed work is the hunting (the integrand evaluations,
        the reference's own cost model, dmrgg.f90:120-131); per-sweep
        traffic is 2 collectives like the sequential path."""
        nb = d - 1
        NLOT = 2 * (R + N)
        me = jax.lax.axis_index(BOND_AXIS)
        base = jnp.minimum(own_lo, nb - max_cnt).astype(jnp.int32)
        idxs = base + jnp.arange(max_cnt)
        live = (idxs >= own_lo) & (idxs < own_hi)
        key, sub = jax.random.split(st.key)
        U = jax.random.uniform(sub, (max_cnt, 2, NLOT), jnp.float64)
        st = st._replace(key=key)

        if getattr(cfg, "rb", False):
            # red-black phases on the mesh: each phase hunts only its
            # parity's live window rows, psum-merges, and every device
            # runs the parity-gated replicated apply — phase 2 sees
            # phase 1's factors fresh, exactly like the single-device rb
            # (cross/engine_jacobi.py::_rb_phases)
            pm_prev = st.pivotmax_prev
            pms, pns = [], []
            for par in (0, 1):
                st = st._replace(pivotmax_prev=pm_prev)
                gpar = (jnp.arange(nb) % 2) == par
                st = _jac_phase(st, it, U, base, live & ((idxs % 2) == par),
                                own_lo, own_hi, gpar)
                pms.append(st.pivotmax)
                pns.append(st.pivotmin)
            pm = jnp.maximum(pms[0], pms[1])
            pn = jnp.where(pns[0] < 0, pns[1],
                           jnp.where(pns[1] < 0, pns[0],
                                     jnp.minimum(pns[0], pns[1])))
            st = st._replace(pivotmax=pm, pivotmin=pn, pivotmax_prev=pm)
            return _scalar_fold(st)
        st = _jac_phase(st, it, U, base, live, own_lo, own_hi, None)
        return _scalar_fold(st)

    def _jac_phase(st: CrossState, it, U, base, live, own_lo, own_hi,
                   live_global):
        """One hunt + psum-merge + replicated apply over the given live
        window rows; live_global optionally parity-gates the global
        acceptance (rb phases)."""
        nb = d - 1
        me = jax.lax.axis_index(BOND_AXIS)

        hunt, amax_l, neval_l, padded_l = jax.lax.cond(
            (it % 2) == 1,
            lambda a: kit.jacobi_hunt(a[0], a[1], True, a[2], max_cnt, a[3]),
            lambda a: kit.jacobi_hunt(a[0], a[1], False, a[2], max_cnt, a[3]),
            (st, U, base, live))

        dt = st.amax.dtype
        RN = R * N
        W = 5 + 2 * RN
        block = jnp.concatenate([
            hunt["ii"][:, None].astype(dt), hunt["jj"][:, None].astype(dt),
            hunt["kk"][:, None].astype(dt), hunt["qq"][:, None].astype(dt),
            hunt["pivot"][:, None],
            hunt["acol"].reshape(max_cnt, RN),
            hunt["arow"].reshape(max_cnt, RN),
        ], axis=1)
        # mask dead window rows by SELECTION, not multiplication: a dead
        # row's hunt outputs are explicitly garbage (jacobi_hunt's
        # contract) and can be NaN (e.g. 0/0 in a fully-masked residual
        # normalization) — NaN * 0 = NaN would poison the psum row for
        # the bond's true owner and silently veto its acceptance forever
        block = jnp.where(live[:, None], block, 0.0)
        rows = jax.lax.dynamic_update_slice(
            jnp.zeros((nb, W), dt), block, (base, jnp.int32(0)))
        extra = jnp.zeros((1, W), dt).at[0, me].set(amax_l)
        TP = jax.lax.psum(jnp.concatenate([rows, extra], axis=0), BOND_AXIS)
        hunt_full = dict(
            ii=jnp.round(TP[:nb, 0]).astype(jnp.int_),
            jj=jnp.round(TP[:nb, 1]).astype(jnp.int_),
            kk=jnp.round(TP[:nb, 2]).astype(jnp.int_),
            qq=jnp.round(TP[:nb, 3]).astype(jnp.int_),
            pivot=TP[:nb, 4],
            acol=TP[:nb, 5:5 + RN].reshape(nb, R, N),
            arow=TP[:nb, 5 + RN:].reshape(nb, N, R),
        )
        amax_g = jnp.max(TP[nb, :ndev])
        st = st._replace(amax=amax_g, neval=neval_l, padded=padded_l)
        corner_count = (jnp.arange(nb) >= own_lo) & (jnp.arange(nb) < own_hi)
        st = kit.jacobi_apply(st, hunt_full, corner_count, live=live_global,
                              skip_corners=live_global is not None)
        return st

    def pvalue(st: CrossState, w, own_lo, own_hi):
        """Distributed quadrature value: per-device chain product over its
        authoritative cores, then a log2-depth stride-doubling product over
        the mesh (the collective rendering of the reference's binary-tree pairwise
        GEMM reduce, dmrgg.f90:1356-1405): at step k every device multiplies
        its partial with the partial 2^k positions to its right (identity
        past the edge), so after ceil(log2 ndev) ppermutes device 0 holds
        the full ordered product.  O(log ndev) (R, R) messages instead of an
        all_gather of ndev R^2 blocks + an O(ndev)-depth replicated chain."""
        from ..ops.dd import _exact_pow2, pow2_balance
        from ..ops.dense import balanced_matmul_chain

        me = jax.lax.axis_index(BOND_AXIS)
        cnt = own_hi - own_lo + jnp.where(me == ndev - 1, 1, 0)

        def balance(part, ex):
            # exact power-of-2 norm balancing (see engine.value_fn): long
            # chains overflow the raw partial products
            part, e = pow2_balance(part)
            return part, ex + e

        # slab-local ordered product: all d LU-solved mode matrices in one
        # batched build (the state is replicated, so this is one einsum),
        # the slab window sliced out (identity-padded so the slice never
        # clamps) and dead rows masked to identity, then a log-depth
        # pairwise tree instead of a max_cores-step serial fori_loop
        mats = kit.value_mats(st, w)                          # (d, R, R)
        pad_eye = jnp.broadcast_to(jnp.eye(R, dtype=mats.dtype),
                                   (max_cores, R, R))
        sl = jax.lax.dynamic_slice_in_dim(
            jnp.concatenate([mats, pad_eye], axis=0),
            own_lo.astype(jnp.int32), max_cores, axis=0)
        live = jnp.arange(max_cores) < cnt
        sl = jnp.where(live[:, None, None], sl,
                       jnp.eye(R, dtype=sl.dtype))
        part, ex = balanced_matmul_chain(sl)

        stride = 1
        while stride < ndev:
            # pull the partial of the device `stride` to the right; devices
            # past the edge contribute the identity (wrap-around partials
            # are masked off)
            perm = [(src, (src - stride) % ndev) for src in range(ndev)]
            right = jax.lax.ppermute(part, BOND_AXIS, perm)
            right_ex = jax.lax.ppermute(ex, BOND_AXIS, perm)
            eye = jnp.eye(R, dtype=part.dtype)
            live = me + stride < ndev
            right = jnp.where(live, right, eye)
            part, ex = balance(part @ right,
                               ex + jnp.where(live, right_ex, 0.0))
            stride *= 2

        # the ordered product lives on device 0; broadcast its [0, 0] entry
        # (boundary ranks are 1, so that entry is the value)
        val = part[0, 0] * _exact_pow2(ex)
        return jax.lax.psum(jnp.where(me == 0, val, 0.0), BOND_AXIS)

    # ------------------------------------------------------------- runner
    _run_cache: dict = {}

    def make_run_fn(max_sweeps: int, with_quad: bool, accuracy: float | None):
        """The jitted distributed run, built once per run parameters (a
        fresh jit per call would retrace and recompile every cross)."""
        ck = (max_sweeps, with_quad, accuracy)
        if ck not in _run_cache:
            _run_cache[ck] = _make_run_fn(max_sweeps, with_quad, accuracy)
        return _run_cache[ck]

    def _make_run_fn(max_sweeps: int, with_quad: bool, accuracy: float | None):
        def run_body(st: CrossState, w):
            me = jax.lax.axis_index(BOND_AXIS)
            own_lo, own_hi = own_lo_tbl[me], own_hi_tbl[me]
            st = st._replace(key=jax.random.fold_in(st.key, me))
            dt = st.amax.dtype
            vals0 = jnp.zeros((max_sweeps + 1,), dt)
            pmax0 = jnp.zeros((max_sweeps + 1,), dt)
            nev0 = jnp.zeros((max_sweeps + 1,), jnp.int64)
            if with_quad:
                vals0 = vals0.at[0].set(pvalue(st, w, own_lo, own_hi))

            def cond(carry):
                return ~carry[-1]

            def body(carry):
                st, it, strike, vals, pmax, nev, done = carry
                sweep1 = psweep_jacobi if cfg.jacobi else psweep
                st, nev_tot, padded_tot = sweep1(st, it, own_lo, own_hi)
                if with_quad:
                    vals = vals.at[it].set(pvalue(st, w, own_lo, own_hi))
                pmax = pmax.at[it].set(st.pivotmax)
                nev = nev.at[it].set(nev_tot)
                ready = it + 1 >= max_sweeps + 1
                if accuracy is not None:
                    quiet = st.pivotmax <= accuracy * st.amax
                    strike = jnp.where(quiet, strike + 1, 0)
                    ready = ready | (strike >= 3)
                return (st, it + 1, strike, vals, pmax, nev, ready)

            init = (st, jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32),
                    vals0, pmax0, nev0, jnp.asarray(max_sweeps < 1))
            st, it, _, vals, pmax, nev, _ = jax.lax.while_loop(cond, body, init)

            # gather authoritative cores -> replicated complete state
            # (jacobi mode keeps the whole state replicated — no gather)
            if cfg.jacobi:
                cores = st.cores
            else:
                c_idx = jnp.arange(d)
                authority = (c_idx >= own_lo) & (c_idx < own_hi)
                authority = authority | ((c_idx == d - 1) & (me == ndev - 1))
                cores = jax.lax.psum(
                    jnp.where(authority[:, None, None, None], st.cores, 0.0),
                    BOND_AXIS)
            neval = jax.lax.psum(st.neval - kit.init_neval, BOND_AXIS) + kit.init_neval
            padded = (jax.lax.psum(st.padded - init_padded, BOND_AXIS)
                      + init_padded)
            st = st._replace(cores=cores, neval=neval, padded=padded)
            return st, it - 1, vals, pmax, nev

        state_spec = CrossState(*([P()] * len(CrossState._fields)))
        mapped = jax.shard_map(
            run_body, mesh=mesh,
            in_specs=(state_spec, P()),
            out_specs=(state_spec, P(), P(), P(), P()),
            check_vma=False,
        )
        return jax.jit(mapped)

    return kit, make_run_fn


def cross_parallel(
    fun: Callable,
    n: Sequence[int],
    max_rank: int = 20,
    accuracy: float | None = None,
    pivoting: int = 1,
    quad: Sequence | None = None,
    truth: float | None = None,
    key: int | jax.Array = 0,
    dtype=jnp.float64,
    mesh: Mesh | None = None,
    verbose: bool = False,
    mybonds=None,
    oversample: int = 0,
    sweep_mode: str = "sequential",
    refine_sweeps: int = 0,
    adaptive: float | bool = 0.0,
    chain=None,
) -> CrossResult:
    """Distributed TT-cross over a 1-D bond mesh (the `mpirun -np N` path of
    the reference, dmrgg.f90 dimension-parallel mode).  Same contract as
    cross(); requires len(mesh devices) <= d-1.  mybonds optionally gives
    custom slab boundaries (ndev+1,), as dtt_dmrgg's mybonds argument.
    oversample: cross-and-round past the greedy fixed-rank ceiling, as in
    cross() (the rounding runs replicated after the distributed cross).
    sweep_mode: "sequential" (each device walks its slab bond-by-bond,
    tape replay + boundary fixup) or "jacobi" (slab-level Jacobi — each
    device hunts all its slab's bonds in a few batched integrand calls and
    the acceptance runs replicated; the throughput mode for long chains).
    refine_sweeps: k distributed maxvol pivot-replacement sweeps after the
    greedy cross (parallel/maxvol.py on the same mesh), as
    cross(refine_sweeps=k).
    adaptive: residual-gated hunts as in cross(adaptive=...) — each device
    gates its own slab's bonds on their (replicated-threshold) lottery
    residuals; gated bonds ship zero tapes, so replicas replay
    consistently."""
    n = tuple(int(x) for x in n)
    d = len(n)
    if sweep_mode not in ("sequential", "jacobi", "jacobi-rb"):
        raise ValueError(f"unknown sweep_mode {sweep_mode!r}")
    adaptive = 4096.0 if adaptive is True else float(adaptive)
    if adaptive > 0:
        if int(pivoting) < 0:
            raise ValueError("adaptive gating requires pivoting >= 0")
        if sweep_mode.startswith("jacobi"):
            raise ValueError("adaptive gating applies to sequential sweeps")
    if oversample:
        # refine_sweeps composes like the single-device path: cross at
        # R+k, maxvol-replace pivots at the inflated rank, round to R
        res = cross_parallel(fun, n, max_rank=max_rank + int(oversample),
                             accuracy=accuracy, pivoting=pivoting, quad=quad,
                             truth=truth, key=key, dtype=dtype, mesh=mesh,
                             verbose=verbose, mybonds=mybonds,
                             sweep_mode=sweep_mode, adaptive=adaptive,
                             refine_sweeps=refine_sweeps, chain=chain)
        from ..cross.engine import round_and_revalue

        return round_and_revalue(res, max_rank, quad, truth)
    if mesh is None:
        mesh = bond_mesh()
    se, sp = precision_thresholds(dtype)
    cfg = CrossConfig(d=d, n=n, N=max(n), R=max_rank, piv=int(pivoting),
                      small_element=se, small_pivot=sp,
                      jacobi=sweep_mode.startswith("jacobi"),
                      rb=sweep_mode == "jacobi-rb", adaptive=adaptive)
    kit, make_run_fn = get_parallel_engine(fun, cfg, mesh, mybonds,
                                           chain=chain)

    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    t0 = time.perf_counter()
    st = kit.init_fn(key)   # deterministic -> identical on every device

    with_quad = quad is not None
    w = np.zeros((d, cfg.N))
    if with_quad:
        for c in range(d):
            w[c, : n[c]] = np.asarray(quad[c])
    w = jnp.asarray(w)

    max_sweeps = max_rank - 1
    run_fn = make_run_fn(max_sweeps, with_quad, accuracy)
    st, last_it, vals, pmax, nev = run_fn(st, w)
    last_it = int(last_it)
    vals = np.asarray(vals)
    pmax = np.asarray(pmax)
    nev = np.asarray(nev)

    values, errors = [], []
    if with_quad:
        values = list(vals[: last_it + 1])
        for i in range(1, last_it + 1):
            if truth is not None:
                errors.append(abs(1.0 - vals[i] / truth))
            else:
                prev = vals[i - 1]
                errors.append(abs(1.0 - vals[i] / prev) if prev != 0 else float("nan"))
    from ..utils.metrics import history_from_run

    history = history_from_run(last_it, vals, pmax, nev, truth, with_quad)
    if verbose:
        for rec in history:
            line = f"{rec.it:3d}{rec.direction} n_evals: {rec.n_evals:10d}"
            if rec.err is not None:
                line += f" err {rec.err:9.3e} val {rec.value:.14e}"
            elif rec.cnv is not None:
                line += f" cnv {rec.cnv:9.3e} val {rec.value:.14e}"
            print(line)

    tt = finalize(st, cfg, kit)
    res = CrossResult(
        tt=tt, neval=int(st.neval), sweeps=last_it,
        ranks=tuple(int(x) for x in np.asarray(st.rk)),
        values=values, errors=errors,
        time=time.perf_counter() - t0,
        converged=accuracy is not None and last_it < max_sweeps,
        history=history,
        padded_evals=int(st.padded),
    )
    if refine_sweeps:
        import functools

        from ..cross.engine import _apply_refine
        from .maxvol import maxvol_refine_parallel

        res = _apply_refine(
            res, fun, n, refine_sweeps, quad, truth, state=st,
            refine_fn=functools.partial(maxvol_refine_parallel, mesh=mesh,
                                        mybonds=mybonds))
        res.time = time.perf_counter() - t0
    return res
