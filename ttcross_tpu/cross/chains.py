"""Pivot index-chain reconstruction.

The cross engine identifies each sampled entry by a bond-local tuple
(i, j, k, q): row-chain link i into bond p-1, mode indices j (core p) and
k (core p+1), column-chain link q into bond p+1.  The reference rebuilds the
full d-dimensional multi-index by walking the vip linked lists one element
at a time inside OpenMP loops (dmrgg_fun, dmrgg.f90:1053-1078).

Here the walk is done ONCE per bond visit for all R possible link values as
two masked scans (left prefixes and right suffixes), producing index tables
that candidate batches then simply gather — O(d R) setup instead of
O(d B) per batch, and fully vectorized.

vip layout (0-based): vip[b, s] = (i, j, k, q) for pivot s of bond b, where
bond b sits between cores b and b+1;  i in [0, rk[b]) links into
vip[b-1], q in [0, rk[b+2]) links into vip[b+1].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["left_table", "right_table", "assemble_indices"]


def left_table(vip: jax.Array, p, d: int) -> jax.Array:
    """Left prefix table for bond p: tab[t, s] = index of mode s (s < p) on
    the row chain entered with link t at bond p-1.  Shape (R, d); columns
    >= p are zero."""
    R = vip.shape[1]
    tab = jnp.zeros((R, d), dtype=vip.dtype)
    col = jnp.arange(d)

    def step(carry, u):
        t, tab = carry
        s = p - 1 - u
        valid = s >= 0
        sc = jnp.maximum(s, 0)
        vs = jax.lax.dynamic_index_in_dim(vip, sc, 0, keepdims=False)  # (R, 4)
        j = vs[t, 1]      # (R,) mode index of core s
        t_next = vs[t, 0]
        tab = jnp.where(valid & (col[None, :] == s), j[:, None], tab)
        t = jnp.where(valid, t_next, t)
        return (t, tab), None

    (_, tab), _ = jax.lax.scan(step, (jnp.arange(R, dtype=vip.dtype), tab), jnp.arange(d - 1))
    return tab


def right_table(vip: jax.Array, p, d: int) -> jax.Array:
    """Right suffix table for bond p: tab[t, s] = index of mode s (s > p+1)
    on the column chain entered with link t at bond p+1.  Shape (R, d)."""
    R = vip.shape[1]
    tab = jnp.zeros((R, d), dtype=vip.dtype)
    col = jnp.arange(d)

    def step(carry, u):
        t, tab = carry
        s = p + 1 + u           # bond index; writes mode s+1
        valid = s <= d - 2
        sc = jnp.minimum(s, d - 2)
        vs = jax.lax.dynamic_index_in_dim(vip, sc, 0, keepdims=False)
        k = vs[t, 2]
        t_next = vs[t, 3]
        tab = jnp.where(valid & (col[None, :] == s + 1), k[:, None], tab)
        t = jnp.where(valid, t_next, t)
        return (t, tab), None

    (_, tab), _ = jax.lax.scan(step, (jnp.arange(R, dtype=vip.dtype), tab), jnp.arange(d - 1))
    return tab


def advance_left(ltab: jax.Array, vip_p: jax.Array, p) -> jax.Array:
    """Left table of bond p+1 from bond p's table: new chains route through
    bond p's pivots (ltab_{p+1}[t] = ltab_p[vip_p[t,0]] with column p set to
    vip_p[t,1]).  O(R d) instead of an O(d)-step scan."""
    col = jnp.arange(ltab.shape[1])
    nt = jnp.take(ltab, vip_p[:, 0], axis=0)
    return jnp.where(col[None, :] == p, vip_p[:, 1][:, None], nt)


def advance_right(rtab: jax.Array, vip_p1: jax.Array, p) -> jax.Array:
    """Right table of bond p from bond p+1's table (backward recurrence:
    column p+2 = vip_{p+1}[t,2], remainder via link vip_{p+1}[t,3])."""
    col = jnp.arange(rtab.shape[1])
    nt = jnp.take(rtab, vip_p1[:, 3], axis=0)
    return jnp.where(col[None, :] == p + 2, vip_p1[:, 2][:, None], nt)


def _compose_chain_ops(u, v):
    """Compose two chain-table operators, u applied FIRST, v second.

    An operator is the effect of a run of bonds on a (R, d) table:
    ``op(tab) = where(m, w, tab[g])`` with g a (R,) link-gather map, w a
    (R, d) overlay holding the mode indices the run writes, and m a (d,)
    column mask of written columns.  Composition is itself such an
    operator — ``(v∘u)(tab) = where(m_v, w_v, u(tab)[g_v])`` — which makes
    the per-bond recurrence of advance_left/advance_right ASSOCIATIVE and
    unlocks a log2(d)-depth associative_scan in place of the d-step serial
    lax.scan (the jacobi sweep's latency wall at C_256: four 254-step
    scans per sweep)."""
    g_u, w_u, m_u = u
    g_v, w_v, m_v = v
    g = jnp.take_along_axis(g_u, g_v, axis=-1)
    wg = jnp.take_along_axis(w_u, g_v[..., None], axis=-2)
    w = jnp.where(m_v[..., None, :], w_v, wg)
    return g, w, m_u | m_v


def _chain_ops(vip: jax.Array, d: int, left: bool):
    """Per-bond operator elements for the associative chain-table scan.

    left:  A_p(tab) = where(col==p,   vip[p,:,1], tab[vip[p,:,0]])
    right: C_p(tab) = where(col==p+1, vip[p,:,2], tab[vip[p,:,3]])"""
    nb = d - 1
    R = vip.shape[1]
    col = jnp.arange(d)
    ps = jnp.arange(nb)
    wcol = ps + (0 if left else 1)
    m = col[None, :] == wcol[:, None]                      # (nb, d)
    val = vip[:, :, 1 if left else 2]                      # (nb, R)
    w = jnp.where(m[:, None, :], val[:, :, None],
                  jnp.zeros((nb, R, d), vip.dtype))
    g = vip[:, :, 0 if left else 3]
    return g, w, m


def all_left_tables(vip: jax.Array, d: int) -> jax.Array:
    """LT (d-1, R, d): left table of every bond, log2(d)-depth.

    LT[p] = (A_{p-1} ∘ ... ∘ A_0)(0): the w component of the (p-1)-th
    INCLUSIVE prefix composition (unwritten columns stay zero), prefixes
    by one associative_scan instead of a (d-1)-step serial lax.scan."""
    R = vip.shape[1]
    elems = _chain_ops(vip, d, left=True)
    _, W, _ = jax.lax.associative_scan(_compose_chain_ops, elems)
    lt0 = jnp.zeros((1, R, d), vip.dtype)
    return jnp.concatenate([lt0, W[:-1]], axis=0)


def all_right_tables(vip: jax.Array, d: int) -> jax.Array:
    """RT (d-1, R, d): right table of every bond, log2(d)-depth.

    RT[p] = (C_{p+1} ∘ ... ∘ C_{d-2})(0) with C_{d-2} applied first: the
    w component of the (p+1)-th inclusive SUFFIX composition.  In
    associative_scan(reverse=True) the accumulated argument carries the
    later-indexed bonds (the ones applied FIRST), so the combine keeps
    _compose_chain_ops' (first, second) argument order."""
    R = vip.shape[1]
    elems = _chain_ops(vip, d, left=False)
    _, W, _ = jax.lax.associative_scan(
        _compose_chain_ops, elems, reverse=True)
    rt0 = jnp.zeros((1, R, d), vip.dtype)
    return jnp.concatenate([W[1:], rt0], axis=0)


def pivot_index_sets(vip, rk):
    """Host-side decode of the pivot chains into explicit index sets:
    I[b] = list of left prefix tuples (modes 0..b), J[b] = right suffix
    tuples (modes b+1..d-1) for every bond b.  Used by the extended-
    precision refinement (cross/refine.py) and by tests."""
    import numpy as np

    vip = np.asarray(vip)
    rk = np.asarray(rk)
    nb = vip.shape[0]
    d = nb + 1
    I, J = [], []
    for b in range(nb):
        Is, Js = [], []
        for s in range(rk[b + 1]):
            pre = [0] * (b + 1)
            pre[b] = int(vip[b, s, 1])
            t = int(vip[b, s, 0])
            for sb in range(b - 1, -1, -1):
                pre[sb] = int(vip[sb, t, 1])
                t = int(vip[sb, t, 0])
            Is.append(tuple(pre))
            suf = [0] * (d - b - 1)
            suf[0] = int(vip[b, s, 2])
            t = int(vip[b, s, 3])
            for sb in range(b + 1, d - 1):
                suf[sb - b] = int(vip[sb, t, 2])
                t = int(vip[sb, t, 3])
            Js.append(tuple(suf))
        I.append(Is)
        J.append(Js)
    return I, J


def assemble_indices(ltab, rtab, p, i, j, k, q, d: int) -> jax.Array:
    """Full (B, d) multi-index for candidates (i, j, k, q) at bond p using
    precomputed chain tables."""
    col = jnp.arange(d)
    left = jnp.take(ltab, i, axis=0)    # (B, d)
    right = jnp.take(rtab, q, axis=0)   # (B, d)
    ind = jnp.where(col[None, :] < p, left, 0)
    ind = jnp.where(col[None, :] > p + 1, right, ind)
    ind = jnp.where(col[None, :] == p, j[:, None], ind)
    ind = jnp.where(col[None, :] == p + 1, k[:, None], ind)
    return ind
