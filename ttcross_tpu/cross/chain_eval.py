"""Chain-structured integrand evaluation (interface states).

The reference evaluates every sampled entry by reconstructing its full
d-dimensional multi-index and calling the scalar integrand — O(d) work
per entry inside OpenMP loops (dmrgg_fun, dmrgg.f90:1053-1078, called
from the hunt loops at dmrgg.f90:455-463, 515-582).  Many integrands of
interest, however, are *chain-structured*: the value factors through a
small per-prefix state that composes ASSOCIATIVELY along the dimension
axis — e.g. the Ising C_m integrand 2/(v·w)·∏W (test_crs_ising.f90:
176-218) is a 4-component product/prefix-sum monoid, the product
Gaussian is a 1-component product monoid, and the equicorrelated MVN
pdf a 3-component (Σx, Σx², ∏W) monoid.

For such integrands the cross engine's hunt candidates at bond b share
their left chain (one of R pivot prefixes) and right chain (one of R
suffixes), so a sweep's candidate evaluations collapse to

    1. lift every chain-table entry to a monoid element      O(d·R) per side
    2. log₂(d)-depth masked pairwise merges -> interface
       states  Ls[b, i], Rs[b, q]                            O(d·R·log d)
    3. per candidate: 3 merges + a finalize                  O(1)  (!)

instead of O(d) table lookups + scan per candidate.  This is the TT
analogue of cached interface tensors, rendered for the device: steps 1-2
are dense vector work, step 3 is broadcastable elementwise math over the
candidate batch.  At C_256 (d = 255) it removes ~99% of the hunt's
integrand FLOPs; the evaluated VALUES agree with the full integrand to
rounding-order (the merge tree is a different association of the same
products/sums).

Protocol
--------
A ChainSpec supplies four callables; all must be jax-traceable,
batched, and broadcast over leading axes:

  identity()       -> state pytree of scalars (the monoid unit)
  lift(dims, idx)  -> state with leaves shaped like dims/idx (int32
                      arrays, broadcast together); dims are mode ids so
                      heterogeneous mode tables are supported
  merge(a, b)      -> state (ASSOCIATIVE; a is the left block)
  finalize(state)  -> values (same leading shape)

`fun(ind) == finalize(reduce(merge, [lift(s, ind[:, s]) for s]))` must
hold (up to association order); `chain_fun` builds exactly that full
evaluator so one spec can serve as both the integrand and the fast
path — tests assert the equivalence.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["ChainSpec", "chain_fun", "reduce_merge", "interface_states",
           "ChainEvaluator"]


class ChainSpec(NamedTuple):
    identity: Callable
    lift: Callable
    merge: Callable
    finalize: Callable


def _tree_where(mask, a, b):
    """tree_map where with a broadcast mask (mask has no trailing axes)."""
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(mask, x, y), a, b)


def reduce_merge(spec: ChainSpec, states, length: int):
    """Order-preserving log₂-depth reduction of `states` (leaves
    (..., length)) along the LAST axis with spec.merge.  Pads to the
    next power of two with the identity."""
    size = 1
    while size < max(length, 1):
        size *= 2
    ident = spec.identity()
    if size != length:
        states = jax.tree_util.tree_map(
            lambda x, e: jnp.concatenate(
                [x, jnp.full(x.shape[:-1] + (size - length,), e, x.dtype)],
                axis=-1),
            states, ident)
    while size > 1:
        half = size // 2
        states = spec.merge(
            jax.tree_util.tree_map(lambda x: x[..., 0:size:2], states),
            jax.tree_util.tree_map(lambda x: x[..., 1:size:2], states))
        size = half
    return jax.tree_util.tree_map(lambda x: x[..., 0], states)


def chain_fun(spec: ChainSpec, d: int):
    """Full-index integrand derived from the spec:
    fun(ind (B, d) int32) -> (B,) — the generic evaluator for entries
    that are not hunt candidates (initial search, accchk, tests)."""
    def fun(ind):
        ind = jnp.asarray(ind)
        dims = jnp.broadcast_to(jnp.arange(d, dtype=ind.dtype),
                                ind.shape)
        return spec.finalize(reduce_merge(spec, spec.lift(dims, ind), d))

    return fun


def interface_states(spec: ChainSpec, LT, RT, d: int):
    """Interface states from the bond chain tables.

    LT/RT (nb, R, d): left/right multi-index tables of every bond
    (cross/chains.py::all_left_tables/all_right_tables).  Returns
    (Ls, Rs) state pytrees with leaves (nb, R):
      Ls[b, i] = merged state of modes 0..b-1 on left chain i,
      Rs[b, q] = merged state of modes b+2..d-1 on right chain q."""
    nb = d - 1
    ps = jnp.arange(nb)
    dims = jnp.arange(d, dtype=LT.dtype)
    dgrid = jnp.broadcast_to(dims, LT.shape)
    ident = spec.identity()

    lmask = dims[None, None, :] < ps[:, None, None]        # modes < b
    Lst = _tree_where(lmask, spec.lift(dgrid, LT),
                      jax.tree_util.tree_map(
                          lambda e: jnp.asarray(e, jnp.result_type(float)),
                          ident))
    Ls = reduce_merge(spec, Lst, d)

    rmask = dims[None, None, :] > (ps + 1)[:, None, None]  # modes > b+1
    Rst = _tree_where(rmask, spec.lift(dgrid, RT),
                      jax.tree_util.tree_map(
                          lambda e: jnp.asarray(e, jnp.result_type(float)),
                          ident))
    Rs = reduce_merge(spec, Rst, d)
    return Ls, Rs


def interface_states_scan(spec: ChainSpec, vip, d: int):
    """Interface states DIRECTLY from the vip chains by a log₂(d)-depth
    scan of (link-gather, state) OPERATORS — no (nb, R, d) index tables,
    no per-mode lift grid, no reduce tree.

    A bond's left operator O_p = (g_p, e_p) acts on a state vector S by
    (O_p S)[t] = merge(S[g_p[t]], e_p[t]) with g_p = vip[p,:,0] and
    e_p[t] = lift(p, vip[p,t,1]); composition
    (O_q ∘ O_p) = (g_p[g_q], merge(e_p[g_q], e_q)) is associative, so an
    inclusive prefix scan yields Ls[b] = prefix payload at b-1 (the
    payload applied to the identity IS the state).  The right states use
    the mirrored operators W_s = (vip[s,:,3], lift(s+1, vip[s,:,2])) with
    (A ∘ B) = (h_B[h_A], merge(f_A, f_B[h_A])) under a reverse scan.

    Payloads are (nb, R) per leaf — ~d times smaller than the
    table+lift+reduce route (interface_states), which this replaces on
    the hot path.  Gathers use take_along_axis: state values are f64, so
    the exact-one-hot f32 matmul trick of chains.py does NOT apply (it
    would round the payload); the index grids are dense and tiny."""
    nb = d - 1
    ps = jnp.arange(nb)
    tm = jax.tree_util.tree_map
    ident = spec.identity()

    def ident_row(e, like):
        return jnp.full((1,) + like.shape[1:], e, like.dtype)

    gL = vip[:, :, 0].astype(jnp.int32)            # (nb, R)
    eL = spec.lift(ps[:, None], vip[:, :, 1])

    def composeL(a, b):
        ga, ea = a
        gb, eb = b
        g = jnp.take_along_axis(ga, gb, axis=-1)
        e = spec.merge(tm(lambda x: jnp.take_along_axis(x, gb, axis=-1), ea),
                       eb)
        return g, e

    _, eP = jax.lax.associative_scan(composeL, (gL, eL))
    Ls = tm(lambda p, e: jnp.concatenate([ident_row(e, p), p[:-1]]), eP,
            ident)

    hR = vip[:, :, 3].astype(jnp.int32)
    fR = spec.lift(ps[:, None] + 1, vip[:, :, 2])

    def composeR(a, b):
        # reverse-scan convention (see chains.all_right_tables): `a`
        # carries the LATER-indexed bonds — the inner run, applied first —
        # and `b` the earlier (outer) run.  (outer ∘ inner) =
        # (h_inner[h_outer], merge(f_outer, f_inner[h_outer])).
        ha, fa = a
        hb, fb = b
        h = jnp.take_along_axis(ha, hb, axis=-1)
        f = spec.merge(fb,
                       tm(lambda x: jnp.take_along_axis(x, hb, axis=-1), fa))
        return h, f

    _, fS = jax.lax.associative_scan(composeR, (hR, fR), reverse=True)
    Rs = tm(lambda p, e: jnp.concatenate([p[1:], ident_row(e, p)]), fS,
            ident)
    return Ls, Rs


def _take_state(S, idx):
    """Gather states along the link axis: leaves (mc, R) + idx (mc, B)
    -> leaves (mc, B)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.take_along_axis(a, idx, axis=1), S)


class ChainEvaluator:
    """Hunt-candidate evaluators bound to one ChainSpec.

    Built once per engine; all methods are traceable and windowable:
    states carry a leading bond axis that callers slice to their window
    (the distributed jacobi path slices to its slab).

    Internal representation: states are PACKED — the K state leaves
    stacked on a trailing axis, (nb, R, K) — so every link gather is ONE
    take_along_axis on the packed array instead of K per-leaf gathers,
    and the prefix scan is a log2(d)-level Hillis-Steele recursive
    doubling (half the levels of associative_scan's up+down sweeps).
    The sweep is kernel-LAUNCH bound (~1300 fused kernels at C_256 in
    the CPU lowering; per-kernel work is tiny), so op count — not FLOPs
    — is the target.
    States returned by states()/states_from_vip() are opaque to callers
    and only valid as inputs to this evaluator's eval_* methods."""

    def __init__(self, spec: ChainSpec, d: int):
        self.spec = spec
        self.d = d
        self.fun = chain_fun(spec, d)
        leaves, self._treedef = jax.tree_util.tree_flatten(spec.identity())
        self._K = len(leaves)
        self._ident = leaves

    def _pack(self, states):
        leaves = jax.tree_util.tree_flatten(states)[0]
        shp = jnp.broadcast_shapes(*[jnp.shape(x) for x in leaves])
        return jnp.stack([jnp.broadcast_to(x, shp) for x in leaves],
                         axis=-1)

    def _unpack(self, arr):
        return jax.tree_util.tree_unflatten(
            self._treedef, [arr[..., i] for i in range(self._K)])

    def states(self, LT, RT):
        Ls, Rs = interface_states(self.spec, LT, RT, self.d)
        return self._pack(Ls), self._pack(Rs)

    def states_from_vip(self, vip):
        """Packed interface states straight from the vip chains (the hot
        path: no index tables, no per-leaf gathers).  Semantics match
        interface_states_scan (tested); only the association order of
        the merges differs (rounding-order)."""
        sp = self.spec
        nb = self.d - 1
        R = vip.shape[1]
        ps = jnp.arange(nb)
        ft = jnp.result_type(float)
        identE = jnp.asarray(self._ident, ft)              # (K,)
        iR = jnp.arange(R, dtype=jnp.int32)

        def hs_scan(g, e, reverse: bool):
            """Hillis-Steele inclusive composition scan of (link-gather,
            payload) operators along axis 0.  compose(earlier, later) =
            (g_e[g_l], merge(e_e[g_l], e_l)) for the left/prefix scan;
            the reverse/suffix scan composes (later, earlier) =
            (h_l[h_e], merge(f_e, f_l[h_e])).  Shift-in rows are the
            identity operator (iR gather + identity payload), which
            composes as a no-op — no select needed."""
            n = g.shape[0]
            shift = 1
            while shift < n:
                gI = jnp.broadcast_to(iR, (shift, R))
                eI = jnp.broadcast_to(identE, (shift, R, self._K))
                if not reverse:
                    ga = jnp.concatenate([gI, g[:-shift]])      # earlier op
                    ea = jnp.concatenate([eI, e[:-shift]])
                    gb, eb = g, e
                else:
                    ga = jnp.concatenate([g[shift:], gI])       # later op
                    ea = jnp.concatenate([e[shift:], eI])
                    gb, eb = g, e
                g = jnp.take_along_axis(ga, gb, axis=-1)
                eg = jnp.take_along_axis(ea, gb[..., None], axis=-2)
                if not reverse:
                    m = sp.merge(self._unpack(eg), self._unpack(eb))
                else:
                    m = sp.merge(self._unpack(eb), self._unpack(eg))
                e = self._pack(m)
                shift *= 2
            return e

        gL = vip[:, :, 0].astype(jnp.int32)
        eL = self._pack(sp.lift(ps[:, None], vip[:, :, 1]))
        eL = jnp.broadcast_to(eL.astype(ft), (nb, R, self._K))
        eP = hs_scan(gL, eL, reverse=False)
        identRow = jnp.broadcast_to(identE, (1, R, self._K))
        Ls = jnp.concatenate([identRow, eP[:-1]])

        hR = vip[:, :, 3].astype(jnp.int32)
        fR = self._pack(sp.lift(ps[:, None] + 1, vip[:, :, 2]))
        fR = jnp.broadcast_to(fR.astype(ft), (nb, R, self._K))
        fS = hs_scan(hR, fR, reverse=True)
        Rs = jnp.concatenate([fS[1:], identRow])
        return Ls, Rs

    def update_states(self, Ls, Rs, ii, jj, kk, qq, upd, slots):
        """Append the accepted pivots' interface-state rows in O(1).

        vip is APPEND-ONLY (dmrgg.f90:602-660: accepted pivots extend the
        chains, existing entries never change), so the per-hunt
        states_from_vip scan rebuild is redundant in steady state: every
        existing row of Ls/Rs stays valid, only the new slot row of each
        accepting bond's neighbors is missing.  This computes exactly
        those rows — one gather + one merge per side, batched over bonds
        — and writes them with shifted one-hot selects:

          Ls[p+1][s_p] = merge(Ls[p][i_p],  lift(p,   j_p))   (prefix)
          Rs[p-1][s_p] = merge(lift(p+1, k_p), Rs[p][q_p])    (suffix)

        Ls/Rs: packed (nb, R, K).  ii/jj/kk/qq, upd, slots: (nb,) accept
        rows (slots = the pre-increment rk[p+1], i.e. the written slot).
        The association order equals the left/right fold of the chain
        walk — the plain dmrgg_fun order (dmrgg.f90:1053-1078)."""
        sp = self.spec
        nb = self.d - 1
        ps = jnp.arange(nb)
        R = Ls.shape[1]
        K = self._K
        iR = jnp.arange(R)
        Li = self._unpack(
            jnp.take_along_axis(Ls, ii[:, None, None], axis=1)[:, 0])
        newL = self._pack(sp.merge(Li, sp.lift(ps, jj))).astype(Ls.dtype)
        Rq = self._unpack(
            jnp.take_along_axis(Rs, qq[:, None, None], axis=1)[:, 0])
        newR = self._pack(sp.merge(sp.lift(ps + 1, kk), Rq)).astype(Rs.dtype)
        oh = (iR[None, :] == slots[:, None]) & upd[:, None]      # (nb, R)
        zR = jnp.zeros((1, R), bool)
        zK = jnp.zeros((1, K), Ls.dtype)
        ohL = jnp.concatenate([zR, oh[:-1]])
        nL = jnp.concatenate([zK, newL[:-1]])
        Ls = jnp.where(ohL[:, :, None], nL[:, None, :], Ls)
        ohR = jnp.concatenate([oh[1:], zR])
        nR = jnp.concatenate([newR[1:], zK])
        Rs = jnp.where(ohR[:, :, None], nR[:, None, :], Rs)
        return Ls, Rs

    def _take(self, Sp, idx):
        """ONE gather on the packed states: Sp (mc, R, K) + idx (mc, B)
        -> unpacked leaves (mc, B)."""
        return self._unpack(
            jnp.take_along_axis(Sp, idx[:, :, None], axis=1))

    def eval_cand(self, Lw, Rw, psw, i, j, k, q):
        """Candidates (i, j, k, q) (mc, B) at window bonds psw (mc,)
        -> values (mc, B).  Lw/Rw: window-sliced packed states
        (mc, R, K)."""
        sp = self.spec
        Li = self._take(Lw, i)
        Rq = self._take(Rw, q)
        lj = sp.lift(psw[:, None], j)
        lk = sp.lift(psw[:, None] + 1, k)
        return sp.finalize(sp.merge(sp.merge(Li, lj), sp.merge(lk, Rq)))

    def eval_col(self, Lw, Rw, psw, kk, qq, iN):
        """Column fibers: all (i, j) over (R, N) at fixed (kk, qq) per
        window bond -> (mc, R, N)."""
        sp = self.spec
        L2 = sp.merge(
            jax.tree_util.tree_map(lambda a: a[:, :, None],
                                   self._unpack(Lw)),
            jax.tree_util.tree_map(lambda a: a[:, None, :],
                                   sp.lift(psw[:, None], iN[None, :])))
        Rfix = sp.merge(sp.lift((psw + 1)[:, None], kk[:, None]),
                        self._take(Rw, qq[:, None]))         # (mc, 1)
        return sp.finalize(sp.merge(
            L2, jax.tree_util.tree_map(lambda a: a[:, :, None], Rfix)))

    def eval_row(self, Lw, Rw, psw, ii, jj, iN):
        """Row fibers: all (k, q) over (N, R) at fixed (ii, jj) per
        window bond -> (mc, N, R)."""
        sp = self.spec
        Lfix = sp.merge(self._take(Lw, ii[:, None]),
                        sp.lift(psw[:, None], jj[:, None]))  # (mc, 1)
        R2 = sp.merge(
            jax.tree_util.tree_map(
                lambda a: a[:, :, None],
                sp.lift(psw[:, None] + 1, iN[None, :])),     # (mc, N, 1)
            jax.tree_util.tree_map(lambda a: a[:, None, :],
                                   self._unpack(Rw)))
        return sp.finalize(sp.merge(
            jax.tree_util.tree_map(lambda a: a[:, None, :], Lfix), R2))

    def eval_corner_col(self, Ls, Rs, ps, i0, kk, qq, iN):
        """Corner column fibers (nb, N): mode j varies at fixed
        (i0, kk, qq) per bond (the jacobi corner repair batch)."""
        sp = self.spec
        Li = self._take(Ls, i0[:, None])                     # (nb, 1)
        lj = sp.lift(ps[:, None], iN[None, :])               # (nb, N)
        Rfix = sp.merge(sp.lift((ps + 1)[:, None], kk[:, None]),
                        self._take(Rs, qq[:, None]))         # (nb, 1)
        return sp.finalize(sp.merge(sp.merge(Li, lj), Rfix))

    def eval_corner_row(self, Ls, Rs, ps, ii, jj, q0, iN):
        """Corner row fibers (nb, N): mode k varies at fixed
        (ii, jj, q0) per bond."""
        sp = self.spec
        Lfix = sp.merge(self._take(Ls, ii[:, None]),
                        sp.lift(ps[:, None], jj[:, None]))   # (nb, 1)
        lk = sp.lift(ps[:, None] + 1, iN[None, :])           # (nb, N)
        Rq = self._take(Rs, q0[:, None])
        return sp.finalize(sp.merge(Lfix, sp.merge(lk, Rq)))
