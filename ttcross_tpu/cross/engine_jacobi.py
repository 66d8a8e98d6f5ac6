"""All-bonds-batched (Jacobi) sweep machinery.

The single-device rendering of the reference's dimension-parallel
decomposition taken to its limit (slab = one bond; the staleness license
of dmrgg.f90:822-850, corner repair of dmrgg.f90:928-932): every bond
hunts concurrently against the start-of-sweep factors, so one sweep
costs a fixed number of large batched integrand calls regardless of the
chain length — the throughput mode for long chains (C_256+).

Factored out of engine.py (it carried the sequential, capped, AND jacobi
sweep families).  build_jacobi binds the closures to one engine context
and returns them; the distributed engine (parallel/engine.py) drives
jacobi_hunt window-wise over mesh slabs and replays jacobi_apply
replicated.  Export-cache keys are traced-jaxpr hashes, so this pure
code move keeps warm artifacts valid.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .chains import all_left_tables, all_right_tables, assemble_indices
from .state import CrossState

# f32 contractions state their precision: on GPUs XLA may otherwise run
# them in TF32 (~11 significant bits), which would round lottery weights
# and residual scores
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["build_jacobi"]


def build_jacobi(cfg, fun, d, N, R, NLOT, iR, iN, n_arr, _decode_div,
                 chain_ev=None):
    """Build (make_sweep_jacobi, jacobi_hunt, jacobi_apply,
    sweep_jacobi_body) bound to the engine context: cfg/fun plus the
    static geometry (d, N, R, NLOT) and index vectors (iR, iN, n_arr)
    get_engine already derived.

    chain_ev: optional cross/chain_eval.py::ChainEvaluator for a
    chain-structured integrand — hunt candidates are then evaluated in
    O(1) from per-bond interface states (3 merges + a finalize) instead
    of assembling full (B, d) index batches and paying the O(d)
    integrand per candidate.  n_evals accounting is unchanged (the same
    tensor entries are examined)."""
    ce = chain_ev
    def make_sweep_jacobi(fwd: bool):
        """All-bonds-batched sweep in a STATIC direction: every bond hunts
        CONCURRENTLY against the start-of-sweep factors, so one sweep costs
        a fixed number of large batched integrand calls (1 lottery + 2 piv
        rook passes + 1 corner batch) and ~40 vector ops, independent of
        the chain length.

        This is the single-device rendering of the reference's own
        dimension-parallel decomposition taken to its limit (slab = one
        bond): each bond is its own 'rank', other bonds' pivots land one
        sweep late (the staleness license of dmrgg.f90:822-850), and the
        missing boundary rows/columns are repaired by freshly evaluated
        corner fibers (dmrgg.f90:928-932) — here ONE batched corner call
        for all bonds.  The pivot value stays the exact Schur complement
        of the bond's own growing submatrix (only the candidate pool is
        one sweep stale), so the growing-LU semantics are unchanged.

        The sequential mode remains the default (exact dtt_dmrgg visit
        order); Jacobi is the throughput mode for long chains: C_256
        sweep cost collapses from 254 bond visits to ~5 batched calls."""
        if cfg.piv < 0:
            raise NotImplementedError("jacobi mode supports pivoting >= 0")

        def sweep(args):
            if len(args) == 3:
                st, lw, cs = args
                return _sweep_jacobi_body(st, fwd, lw, cs)
            st, lw = args
            return _sweep_jacobi_body(st, fwd, lw)

        return sweep

    def jacobi_hunt(st: CrossState, U, dir_fwd: bool, base, mc: int,
                    live, lw=None, cs=None):
        """Batched lottery + rook hunt over the mc-bond window starting at
        bond `base` (traced; clamped by the caller so base+mc <= d-1).
        live (mc,) masks window rows outside the caller's slab — a dead
        row contributes nothing to amax / n_evals and its outputs are
        garbage the caller must mask.  The single-device sweep uses the
        full window (base=0, mc=d-1); the distributed engine gives each
        device its own slab window and psums the results (slab-level
        Jacobi).  Returns (hunt dict, amax', neval', padded')."""
        dt = st.cores.dtype
        nb = d - 1
        psw = base + jnp.arange(mc)           # global bond ids (mc,)

        def win(a, off=0, width=None):
            return jax.lax.dynamic_slice_in_dim(a, base + off, mc, axis=0)

        if ce is None:
            LT = win(all_left_tables(st.vip, d))   # (mc, R, d)
            RT = win(all_right_tables(st.vip, d))
        else:
            # interface states, window-sliced.  cs (carried, maintained
            # incrementally by ChainEvaluator.update_states after each
            # apply) skips the per-hunt scan rebuild; cs=None falls back
            # to building them from the vip chains here.
            Lsf, Rsf = cs if cs is not None else ce.states_from_vip(st.vip)
            Lw = jax.tree_util.tree_map(win, Lsf)
            Rw = jax.tree_util.tree_map(win, Rsf)
        rk = st.rk
        rk_l = win(rk)                        # (mc,) rk[p]
        rk_b = win(rk, 1)                     # rk[p+1]
        rk_r = win(rk, 2)                     # rk[p+2]
        n_l = win(n_arr)
        n_r = win(n_arr, 1)
        colf_b = win(st.colf)                 # (mc, R, N, R) slot p
        rowf_b = win(st.rowf, 1)              # (mc, R, N, R) slot p+1
        # rowf permuted so flat row q*N+k reads rowf[p+1][:, k, q]
        rowf_perm = rowf_b.transpose(0, 3, 2, 1).reshape(mc, R * N, R)
        colf_flat = colf_b.reshape(mc, R * N, R)
        rmask_b = (iR[None, :] < rk_b[:, None]).astype(dt)   # (mc, R)
        lv1 = live[:, None]
        cmask = (lv1[:, :, None] & (iR[None, :, None] < rk_l[:, None, None])
                 & (iN[None, None, :] < n_l[:, None, None]))  # (mc, R, N)
        rmask2 = (lv1[:, :, None] & (iN[None, :, None] < n_r[:, None, None])
                  & (iR[None, None, :] < rk_r[:, None, None]))  # (mc, N, R)

        # ---------------- batched lottery (all live bonds, one call)
        smask = iR[None, :] < rk_b[:, None]
        vb = win(st.vip)
        # one-hot any-reductions, not scatter-max .at[].max (a form shaped
        # for the first target, whose scatters were slow; the compare+any is dense)
        linRN = jnp.arange(R * N)
        used_col = jnp.any(((vb[:, :, 0] * N + vb[:, :, 1])[:, :, None]
                            == linRN[None, None, :]) & smask[:, :, None], 1)
        used_row = jnp.any(((vb[:, :, 3] * N + vb[:, :, 2])[:, :, None]
                            == linRN[None, None, :]) & smask[:, :, None], 1)
        # lottery CDFs in f32 via a triangular-ones matmul (shaped for the
        # first target, whose cumsum was a serial loop).
        # The CDF only drives candidate SAMPLING, so f32 sums (exact for
        # the 0/1 masks up to 2^24) are more than enough.
        f32 = jnp.float32
        wcol = (cmask.reshape(mc, R * N) & ~used_col).astype(f32)
        wrow = (rmask2.transpose(0, 2, 1).reshape(mc, R * N)
                & ~used_row).astype(f32)
        if cfg.wlot and lw is not None:
            wcol = wcol * jnp.tile(jnp.abs(win(lw)), (1, R)).astype(f32)
            wrow = wrow * jnp.tile(jnp.abs(win(lw, 1)), (1, R)).astype(f32)
        tri = jnp.triu(jnp.ones((R * N, R * N), f32))   # [j <= i]
        cdf_c = jnp.matmul(wcol, tri, precision=_HIGHEST)
        cdf_r = jnp.matmul(wrow, tri, precision=_HIGHEST)
        below = f32(1.0 - 2.0 ** -20)
        tot_c = cdf_c[:, -1:]
        tot_r = cdf_r[:, -1:]
        t_c = jnp.minimum(U[:, 0, :].astype(f32)
                          * jnp.where(tot_c > 0, tot_c, 1.0),
                          tot_c * below)
        t_r = jnp.minimum(U[:, 1, :].astype(f32)
                          * jnp.where(tot_r > 0, tot_r, 1.0),
                          tot_r * below)
        ssr = jax.vmap(lambda a, v: jnp.searchsorted(
            a, v, side="right", method="compare_all"))
        lin_c = jnp.minimum(ssr(cdf_c, t_c), R * N - 1).astype(jnp.int_)
        lin_r = jnp.minimum(ssr(cdf_r, t_r), R * N - 1).astype(jnp.int_)
        i_c, j_c = _decode_div(lin_c, N)
        q_c, k_c = _decode_div(lin_r, N)
        nlot_act = rk_l + n_l + n_r + rk_r
        candmask = lv1 & (jnp.arange(NLOT)[None, :] < nlot_act[:, None])
        asm = jax.vmap(assemble_indices, (0, 0, 0, 0, 0, 0, 0, None))
        if ce is None:
            ind = asm(LT, RT, psw, i_c, j_c, k_c, q_c, d)     # (mc, NLOT, d)
            b = fun(ind.reshape(-1, d)).reshape(mc, NLOT)
        else:
            b = ce.eval_cand(Lw, Rw, psw, i_c, j_c, k_c, q_c)
        amax = jnp.maximum(st.amax,
                           jnp.max(jnp.where(candmask, jnp.abs(b), 0.0)))
        neval = st.neval + jnp.sum(
            jnp.where(live, nlot_act, 0)).astype(jnp.int64)
        padded = st.padded + mc * NLOT
        # factor rows via batched gathers (the sequential path's
        # row_lookup, vmapped over bonds)
        from ..ops.dense import batched_row_lookup

        cf = batched_row_lookup(colf_flat, lin_c)
        rf = batched_row_lookup(rowf_perm, lin_r)
        resid = b - jnp.sum(cf * rf * rmask_b[:, None, :], axis=2)
        best = jnp.argmax(jnp.where(candmask, jnp.abs(resid), -1.0), axis=1)

        def take1(a):
            return jnp.take_along_axis(a, best[:, None], axis=1)[:, 0]

        ii, jj, kk, qq = take1(i_c), take1(j_c), take1(k_c), take1(q_c)
        pivot = take1(resid)

        # ---------------- batched rook passes (one integrand call each)
        ci_g, cj_g = jnp.repeat(iR, N), jnp.tile(iN, R)
        rg_k, rg_q = jnp.repeat(iN, R), jnp.tile(iR, N)
        asm_col = jax.vmap(lambda lt, rt, p, kk, qq: assemble_indices(
            lt, rt, p, ci_g, cj_g, jnp.full_like(ci_g, kk),
            jnp.full_like(ci_g, qq), d))
        asm_row = jax.vmap(lambda lt, rt, p, ii, jj: assemble_indices(
            lt, rt, p, jnp.full_like(rg_k, ii), jnp.full_like(rg_k, jj),
            rg_k, rg_q, d))

        c = dict(ii=ii, jj=jj, kk=kk, qq=qq, pivot=pivot,
                 acol=jnp.zeros((mc, R, N), dt),
                 arow=jnp.zeros((mc, N, R), dt),
                 havecol=jnp.zeros((mc,), bool),
                 haverow=jnp.zeros((mc,), bool),
                 crs=jnp.zeros((mc,), jnp.int32),
                 done=~live,
                 amax=amax, neval=neval)

        def amax2(x, y):
            return jnp.maximum(x, y)

        def unified_pass_all(c, is_col: bool):
            # Residual SCORING (the argmax over the fiber residual) runs
            # in f32 (built for the first target, whose f64 was emulated: the
            # (mc, R, N)-sized score einsum was dearer in f64) — pivot
            # SELECTION only needs to rank candidates (the
            # reference's idamax makes no precision promise either).  The
            # selected pivot VALUE is recomputed exactly in f64 below (one
            # masked dot per bond) — acceptance thresholds, factor borders
            # and the growing LU never see f32.
            f32 = jnp.float32
            live = ~c["done"]                                  # (mc,)
            crs = c["crs"] + 1
            if is_col:
                if ce is None:
                    ind = asm_col(LT, RT, psw, c["kk"], c["qq"])  # (mc,R*N,d)
                    vals = fun(ind.reshape(-1, d)).reshape(mc, R, N)
                else:
                    vals = ce.eval_col(Lw, Rw, psw, c["kk"], c["qq"], iN)
                acol = jnp.where(cmask, vals, 0.0)
                amax = amax2(c["amax"], jnp.max(jnp.abs(acol)))
                dnev = jnp.sum(jnp.where(live, rk_l * n_l, 0)).astype(jnp.int64)
                u = batched_row_lookup(
                    rowf_perm, c["qq"] * N + c["kk"]) * rmask_b  # (mc, R)
                bcol_s = acol.astype(f32) - jnp.einsum(
                    "pinr,pr->pin", colf_b.astype(f32), u.astype(f32),
                    precision=_HIGHEST)
                sc = jnp.where(cmask, jnp.abs(bcol_s), -1.0)
                i2 = jnp.argmax(jnp.max(sc, axis=2), axis=1)
                j2 = jnp.argmax(jnp.take_along_axis(
                    sc, i2[:, None, None], axis=1)[:, 0, :], axis=1)
                havecol, haverow = jnp.ones((mc,), bool), c["haverow"]
                budget = haverow & (crs >= 2 * cfg.piv)
                stat = haverow & (i2 == c["ii"]) & (j2 == c["jj"])
                upd = ~budget
                lin2 = i2 * N + j2
                a_sel = jnp.take_along_axis(acol.reshape(mc, -1),
                                            lin2[:, None], 1)[:, 0]
                c_sel = batched_row_lookup(colf_flat, lin2) * rmask_b
                pv = a_sel - jnp.sum(c_sel * u, axis=1)        # exact f64
                new = dict(
                    ii=jnp.where(upd, i2, c["ii"]),
                    jj=jnp.where(upd, j2, c["jj"]),
                    kk=c["kk"], qq=c["qq"],
                    pivot=jnp.where(upd, pv, c["pivot"]),
                    acol=acol, arow=c["arow"])
            else:
                if ce is None:
                    ind = asm_row(LT, RT, psw, c["ii"], c["jj"])
                    vals = fun(ind.reshape(-1, d)).reshape(mc, N, R)
                else:
                    vals = ce.eval_row(Lw, Rw, psw, c["ii"], c["jj"], iN)
                arow = jnp.where(rmask2, vals, 0.0)
                amax = amax2(c["amax"], jnp.max(jnp.abs(arow)))
                dnev = jnp.sum(jnp.where(live, n_r * rk_r, 0)).astype(jnp.int64)
                cw = batched_row_lookup(
                    colf_flat, c["ii"] * N + c["jj"]) * rmask_b
                brow_s = arow.astype(f32) - jnp.einsum(
                    "pr,prnq->pnq", cw.astype(f32), rowf_b.astype(f32),
                    precision=_HIGHEST)
                sr = jnp.where(rmask2, jnp.abs(brow_s), -1.0)
                k2 = jnp.argmax(jnp.max(sr, axis=2), axis=1)
                q2 = jnp.argmax(jnp.take_along_axis(
                    sr, k2[:, None, None], axis=1)[:, 0, :], axis=1)
                havecol, haverow = c["havecol"], jnp.ones((mc,), bool)
                budget = havecol & (crs >= 2 * cfg.piv)
                stat = havecol & (k2 == c["kk"]) & (q2 == c["qq"])
                upd = ~budget
                a_sel = jnp.take_along_axis(arow.reshape(mc, -1),
                                            (k2 * R + q2)[:, None], 1)[:, 0]
                r_sel = batched_row_lookup(rowf_perm, q2 * N + k2) * rmask_b
                pv = a_sel - jnp.sum(cw * r_sel, axis=1)       # exact f64
                new = dict(
                    ii=c["ii"], jj=c["jj"],
                    kk=jnp.where(upd, k2, c["kk"]),
                    qq=jnp.where(upd, q2, c["qq"]),
                    pivot=jnp.where(upd, pv, c["pivot"]),
                    acol=c["acol"], arow=arow)
            new.update(havecol=havecol, haverow=haverow, crs=crs,
                       done=budget | (upd & stat),
                       amax=amax, neval=c["neval"] + dnev)

            def sel(a, b2):
                br = live.reshape((mc,) + (1,) * (a.ndim - 1))
                return jnp.where(br, a, b2)

            out = {k: (sel(v, c[k]) if k not in ("amax", "neval") else v)
                   for k, v in new.items()}
            out["amax"] = jnp.where(live.any(), new["amax"], c["amax"])
            out["neval"] = new["neval"]
            return out

        if cfg.piv == 0:
            # seed fibers once: one col call + one row call (all bonds)
            if ce is None:
                ind_col = asm_col(LT, RT, psw, c["kk"], c["qq"])
                vals = fun(ind_col.reshape(-1, d)).reshape(mc, R, N)
            else:
                vals = ce.eval_col(Lw, Rw, psw, c["kk"], c["qq"], iN)
            acol = jnp.where(cmask, vals, 0.0)
            if ce is None:
                ind_row = asm_row(LT, RT, psw, c["ii"], c["jj"])
                vals = fun(ind_row.reshape(-1, d)).reshape(mc, N, R)
            else:
                vals = ce.eval_row(Lw, Rw, psw, c["ii"], c["jj"], iN)
            arow = jnp.where(rmask2, vals, 0.0)
            amax = jnp.maximum(c["amax"], jnp.maximum(
                jnp.max(jnp.abs(acol)), jnp.max(jnp.abs(arow))))
            neval = c["neval"] + jnp.sum(
                jnp.where(live, rk_l * n_l + n_r * rk_r, 0)).astype(jnp.int64)
            c.update(acol=acol, arow=arow, amax=amax, neval=neval)
            padded = padded + 2 * mc * R * N
        else:
            for t in range(2 * cfg.piv):
                c = unified_pass_all(c, dir_fwd == (t % 2 == 0))
            padded = padded + 2 * cfg.piv * mc * R * N
        hunt = dict(ii=c["ii"], jj=c["jj"], kk=c["kk"], qq=c["qq"],
                    pivot=c["pivot"], acol=c["acol"], arow=c["arow"])
        return hunt, c["amax"], c["neval"], padded

    def jacobi_apply(st: CrossState, hunt, corner_count=None,
                     live=None, skip_corners: bool = False,
                     ret_accept: bool = False):
        """Batched acceptance + corner repair + vectorized reconstruction
        for a FULL-width (d-1 bonds) jacobi hunt result.  Deterministic in
        (st, hunt): on a mesh every device runs this replicated on the
        psum-merged hunt, keeping the whole state exactly consistent.

        st must already carry the (globally merged) post-hunt amax /
        neval / padded.  corner_count (d-1,) bool: which corner fibers
        THIS caller counts into neval (the distributed engine counts a
        bond's corners only on its owner; the evaluation itself is
        replicated)."""
        dt = st.cores.dtype
        nb = d - 1
        ps = jnp.arange(nb)
        ii, jj, kk, qq = hunt["ii"], hunt["jj"], hunt["kk"], hunt["qq"]
        pivot, acol, arow = hunt["pivot"], hunt["acol"], hunt["arow"]
        amax = st.amax
        rk_b = st.rk[1:-1]
        n_l = n_arr[:-1]
        n_r = n_arr[1:]
        rmask_b = (iR[None, :] < rk_b[:, None]).astype(dt)   # (nb, R)
        rowf_perm = st.rowf[1:].transpose(0, 3, 2, 1).reshape(nb, R * N, R)
        colf_flat = st.colf[:-1].reshape(nb, R * N, R)

        # ---------------- batched acceptance + vectorized replay
        # NOTE: every accept-slot write below is a one-hot masked SELECT
        # (where over a slot mask), not a scatter .at[].set — a form
        # shaped for the first target, whose scatters were slow at any size; this
        # function carries ~10 of them.
        upd = ((jnp.abs(pivot) > cfg.small_element * amax)
               & (jnp.abs(pivot) > cfg.small_pivot * st.pivotmax_prev)
               & (rk_b < R))
        if live is not None:
            # red-black phase gating: only this parity's bonds accept
            # (their hunt rows are the live ones; dead rows are garbage)
            upd = upd & live
        piv_safe = jnp.where(jnp.abs(pivot) > 0, pivot, 1.0)
        from ..ops.dense import batched_row_lookup

        c_new = batched_row_lookup(colf_flat, ii * N + jj) * rmask_b  # (nb, R)
        u_new = batched_row_lookup(rowf_perm, qq * N + kk) * rmask_b
        s_arr = rk_b.astype(jnp.int32)                         # slot per bond
        one_hot_s = iR[None, :] == s_arr[:, None]              # (nb, R)
        ohs_u = one_hot_s & upd[:, None]                       # accept slots

        vip_new = jnp.stack([ii, jj, kk, qq], axis=1).astype(jnp.int32)
        vip = jnp.where(ohs_u[:, :, None], vip_new[:, None, :], st.vip)
        lu_c = jnp.where(ohs_u[:, :, None], c_new[:, None, :], st.lu_c)
        lu_u = jnp.where(ohs_u[:, :, None], u_new[:, None, :], st.lu_u)
        lu_d = jnp.where(ohs_u, pivot[:, None], st.lu_d)
        # NOTE the FACTOR-CRITICAL contractions here stay einsum: on the
        # accelerator this engine was first built for, the dot_general lowering's
        # pair products were more accurate than a broadcast-multiply +
        # reduce-sum under its emulated f64, and that noise fed the
        # growing factors and degraded pivot quality.  Telemetry-only
        # paths (value chain, finalize) use the sum form instead
        # (ROADMAP Design 4 asks whether one form suffices).
        new_row = jnp.where(one_hot_s, 1.0,
                            -jnp.einsum("pr,prs->ps", c_new, st.itl))
        itl = jnp.where(ohs_u[:, :, None], new_row[:, None, :], st.itl)
        new_col = jnp.where(one_hot_s, 1.0 / piv_safe[:, None],
                            -jnp.einsum("pab,pb->pa", st.itt, u_new)
                            / piv_safe[:, None])
        itt = jnp.where(ohs_u[:, None, :], new_col[:, :, None], st.itt)
        rk = st.rk.at[1:d].add(upd.astype(st.rk.dtype))
        apiv = jnp.abs(pivot)
        any_acc = jnp.any(upd)
        pm = jnp.max(jnp.where(upd, apiv, -jnp.inf))
        pn = jnp.min(jnp.where(upd, apiv, jnp.inf))
        pivotmax = jnp.where(any_acc, pm, -1.0)
        pivotmin = jnp.where(any_acc, pn, -1.0)
        st = st._replace(vip=vip, lu_c=lu_c, lu_u=lu_u, lu_d=lu_d,
                         itl=itl, itt=itt, rk=rk,
                         pivotmax=pivotmax, pivotmin=pivotmin)

        # ---------------- corner fibers (one batched call, dmrgg.f90:928-932)
        # A corner is missing only when ADJACENT bonds accept in the SAME
        # apply; red-black phases separate neighbors by parity, so
        # lmiss/rmiss are identically False there and rb callers skip the
        # whole block (skip_corners=True) — fresh rows are re-evaluated by
        # the other phase's padded hunt fibers instead.
        if skip_corners:
            st = _jacobi_reconstruct(st, upd, acol, arow, c_new, u_new,
                                     itl, itt, one_hot_s, piv_safe,
                                     pivotmax)
            return (st, upd, s_arr) if ret_accept else st
        lmiss = upd & jnp.concatenate([jnp.zeros((1,), bool), upd[:-1]])
        rmiss = upd & jnp.concatenate([upd[1:], jnp.zeros((1,), bool)])
        i_newL = (st.rk[:-2] - 1).astype(jnp.int32)            # new left link
        q_newR = (st.rk[2:] - 1).astype(jnp.int32)
        if ce is None:
            LT2 = all_left_tables(st.vip, d)
            RT2 = all_right_tables(st.vip, d)
            asm_cc = jax.vmap(lambda lt, rt, p, i0, kk, qq: assemble_indices(
                lt, rt, p, jnp.full((N,), i0), iN, jnp.full((N,), kk),
                jnp.full((N,), qq), d))
            asm_rc = jax.vmap(lambda lt, rt, p, ii, jj, q0: assemble_indices(
                lt, rt, p, jnp.full((N,), ii), jnp.full((N,), jj), iN,
                jnp.full((N,), q0), d))
            ind_cc = asm_cc(LT2, RT2, ps, i_newL, kk, qq)      # (nb, N, d)
            ind_rc = asm_rc(LT2, RT2, ps, ii, jj, q_newR)
            vals_c = fun(jnp.concatenate([ind_cc, ind_rc])
                         .reshape(-1, d)).reshape(2, nb, N)
        else:
            Ls2, Rs2 = ce.states_from_vip(st.vip)
            vals_c = jnp.stack([
                ce.eval_corner_col(Ls2, Rs2, ps, i_newL, kk, qq, iN),
                ce.eval_corner_row(Ls2, Rs2, ps, ii, jj, q_newR, iN)])
        corner_col = jnp.where(lmiss[:, None] & (iN[None, :] < n_l[:, None]),
                               vals_c[0], 0.0)                 # (nb, N)
        corner_row = jnp.where(rmiss[:, None] & (iN[None, :] < n_r[:, None]),
                               vals_c[1], 0.0)
        cc = jnp.ones((nb,), bool) if corner_count is None else corner_count
        neval = st.neval + jnp.sum(
            jnp.where(cc & lmiss, n_l, 0)
            + jnp.where(cc & rmiss, n_r, 0)).astype(jnp.int64)
        padded = st.padded + 2 * nb * N
        st = st._replace(neval=neval, padded=padded)
        ohl = (iR[None, :] == i_newL[:, None]) & lmiss[:, None]   # (nb, R)
        acol = jnp.where(ohl[:, :, None], corner_col[:, None, :], acol)
        ohr = (iR[None, :] == q_newR[:, None]) & rmiss[:, None]
        arow = jnp.where(ohr[:, None, :], corner_row[:, :, None], arow)

        st = _jacobi_reconstruct(st, upd, acol, arow, c_new, u_new,
                                 itl, itt, one_hot_s, piv_safe, pivotmax)
        return (st, upd, s_arr) if ret_accept else st

    def _jacobi_reconstruct(st: CrossState, upd, acol, arow, c_new,
                            u_new, itl, itt, one_hot_s, piv_safe,
                            pivotmax) -> CrossState:
        """Reconstruction phases A/B shared by the corner and corner-free
        (rb) apply paths: raw fiber + LU-slice writes, then factor borders
        from the post-A factors."""
        nb = d - 1
        ps = jnp.arange(nb)

        # phase A: raw fibers + LU slices — slot-column write on cores[p]
        # (p < nb) and slot-row write on cores[p+1] (p >= 1 region), as
        # dense one-hot selects + static concat of the untouched boundary
        def set_col(arr, body, mask):
            """arr[p, :, :, s_arr[p]] = body[p] where mask[p], p < nb."""
            m = (one_hot_s & mask[:, None])[:, None, None, :]
            return jnp.concatenate(
                [jnp.where(m, body[:, :, :, None], arr[:nb]), arr[nb:]])

        def set_row(arr, body, mask):
            """arr[p+1, s_arr[p], :, :] = body[p] where mask[p]."""
            m = (one_hot_s & mask[:, None])[:, :, None, None]
            return jnp.concatenate(
                [arr[:1], jnp.where(m, body[:, None, :, :], arr[1:])])

        cores = set_col(st.cores, acol, upd)
        cores = set_row(cores, arow, upd)
        # (einsum, not sum-form: factor-critical — see phase A note)
        itl_prev = jnp.concatenate([itl[:1], itl[:-1]])        # (nb, R, R)
        slc_l = jnp.einsum("pab,pbn->pan", itl_prev, acol)
        upd_l = upd & (ps > 0)
        rowf = set_col(st.rowf, slc_l, upd_l)
        itt_next = jnp.concatenate([itt[1:], itt[-1:]])
        slc_r = jnp.einsum("pnr,prb->pnb", arow, itt_next)
        upd_r = upd & (ps < d - 2)
        colf = set_row(st.colf, slc_r, upd_r)

        # phase B: factor borders from post-A factors
        colf_b2 = colf[:-1]
        approx = jnp.einsum("pinr,pr->pin", colf_b2, u_new)
        new_colf = (acol - approx) / piv_safe[:, None, None]
        colf = set_col(colf, new_colf, upd)
        rowf_b2 = rowf[1:]
        approx2 = jnp.einsum("pr,prnq->pnq", c_new, rowf_b2)
        new_rowf = arow - approx2
        rowf = set_row(rowf, new_rowf, upd)

        return st._replace(cores=cores, colf=colf, rowf=rowf,
                           pivotmax_prev=pivotmax)

    def _sweep_jacobi_body(st: CrossState, dir_fwd: bool, lw=None, cs=None):
        """One jacobi sweep.  cs: optional carried packed interface
        states (chain path only) — when given, the return is (st, cs')
        with the states maintained incrementally (update_states) instead
        of rebuilt by scan inside every hunt."""
        nb = d - 1
        key, sub = jax.random.split(st.key)
        U = jax.random.uniform(sub, (nb, 2, NLOT), jnp.float64)
        st = st._replace(key=key)
        if getattr(cfg, "rb", False):
            return _rb_phases(st, U, dir_fwd, lw, cs)
        hunt, amax, neval, padded = jacobi_hunt(
            st, U, dir_fwd, 0, nb, jnp.ones((nb,), bool), lw, cs=cs)
        st = st._replace(amax=amax, neval=neval, padded=padded)
        if cs is None:
            return jacobi_apply(st, hunt)
        st, upd, slots = jacobi_apply(st, hunt, ret_accept=True)
        cs = ce.update_states(cs[0], cs[1], hunt["ii"], hunt["jj"],
                              hunt["kk"], hunt["qq"], upd, slots)
        return st, cs

    def _rb_phases(st: CrossState, U, dir_fwd: bool, lw=None, cs=None):
        """Red-black (two-phase Gauss-Seidel) sweep: even bonds hunt and
        accept batched, THEN odd bonds against the post-even factors.

        Single-phase jacobi hunts every bond against start-of-sweep
        factors, so a bond's factor rows for its neighbor's new pivot are
        one sweep stale and need the corner repair — a ~1 digit quality
        gap vs the sequential visit order at equal rank (C_256 at rank
        10).  With alternating parities a
        bond's NEIGHBORS are always in the other phase: their accepts land
        before its hunt, the hunt's padded fibers re-evaluate the new
        rows fresh (lmiss/rmiss never fire within a phase), and the pivot
        candidate pool sees half-sweep-fresh residuals — sequential-grade
        neighbor coupling at two batched calls per sweep.  Cross-parity
        long-range staleness (chain tables) refreshes between phases too:
        LT/RT are rebuilt from the post-even vip."""
        nb = d - 1
        ps = jnp.arange(nb)
        pm_prev = st.pivotmax_prev
        pms, pns = [], []
        for par in (0, 1):
            live = (ps % 2) == par
            # threshold against the PREVIOUS SWEEP's pivotmax in both
            # phases (dmrgg.f90:598-600 uses the prior iteration's value)
            st = st._replace(pivotmax_prev=pm_prev)
            hunt, amax, neval, padded = jacobi_hunt(
                st, U, dir_fwd, 0, nb, live, lw, cs=cs)
            st = st._replace(amax=amax, neval=neval, padded=padded)
            if cs is None:
                st = jacobi_apply(st, hunt, live=live, skip_corners=True)
            else:
                # maintain the carried states across the phase boundary:
                # phase 2 hunts must see phase 1's new rows (the
                # sequential-grade neighbor coupling rb exists for)
                st, upd, slots = jacobi_apply(st, hunt, live=live,
                                              skip_corners=True,
                                              ret_accept=True)
                cs = ce.update_states(cs[0], cs[1], hunt["ii"], hunt["jj"],
                                      hunt["kk"], hunt["qq"], upd, slots)
            pms.append(st.pivotmax)
            pns.append(st.pivotmin)
        pm = jnp.maximum(pms[0], pms[1])          # -1 sentinel = no accept
        pn = jnp.where(pns[0] < 0, pns[1],
                       jnp.where(pns[1] < 0, pns[0],
                                 jnp.minimum(pns[0], pns[1])))
        st = st._replace(pivotmax=pm, pivotmin=pn, pivotmax_prev=pm)
        return st if cs is None else (st, cs)

    return make_sweep_jacobi, jacobi_hunt, jacobi_apply, _sweep_jacobi_body
