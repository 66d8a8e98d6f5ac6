"""TT algebra: evaluation, contraction, and structural operations.

Functional re-design of tt.f90's generic interfaces (tijk/value/sumall/dot/
norm/+/*/group, tt.f90:54-124).  Everything here is pure, jittable where
shapes allow, and batched: element evaluation takes a (B, d) index matrix
(the reference evaluates one element at a time, dtt_ijk tt.f90:630-652).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from .types import TT

__all__ = [
    "gather",
    "value",
    "full",
    "sumall",
    "contract",
    "dot",
    "norm",
    "add",
    "scale",
    "hadamard",
    "group",
]


def gather(t: TT, ind: jax.Array) -> jax.Array:
    """Batched element evaluation: ind (B, d) int -> values (B,).

    Replaces the reference's per-element matmul chain (dtt_ijk,
    tt.f90:630-652) with one vectorized chain of batched mat-vec products;
    each step is a batched (B, r) x (r, r') contraction.
    """
    ind = jnp.asarray(ind)
    squeeze = ind.ndim == 1
    if squeeze:
        ind = ind[None, :]
    B = ind.shape[0]
    v = jnp.ones((B, 1), dtype=t.dtype)
    for c in range(t.d):
        g = jnp.take(t.cores[c], ind[:, c], axis=1)  # (r, B, r')
        v = jnp.einsum("bi,ibj->bj", v, g)
    out = v[:, 0]
    return out[0] if squeeze else out


def value(t: TT, x: jax.Array, dd: int = 1) -> jax.Array:
    """Quantics-style evaluation of coordinates x in [0,1]^dd (dtt_value,
    tt.f90:702-728): each coordinate is expanded over d/dd modes by repeated
    base-n digit extraction, then the element is gathered."""
    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    d = t.d
    n = t.n
    mm = d // dd
    ind_cols = [None] * d
    for id_ in range(dd):
        xx = x[:, id_]
        xx = jnp.where(xx > 1.0, xx - jnp.floor(xx), xx)
        for j in range(mm):
            pos = id_ * mm + mm - 1 - j
            i = jnp.floor(n[pos] * xx).astype(jnp.int32)
            i = jnp.minimum(i, n[pos] - 1)
            ind_cols[pos] = i
            xx = xx * n[pos] - i
    ind = jnp.stack(ind_cols, axis=1)
    out = gather(t, ind)
    return out[0] if squeeze else out


def full(t: TT) -> jax.Array:
    """Contract to the dense tensor of shape n (for testing; exponential!)."""
    out = t.cores[0][0]  # (n0, r1); r0 == 1
    for c in range(1, t.d):
        out = jnp.tensordot(out, t.cores[c], axes=[[-1], [0]])
    return out[..., 0]  # r_d == 1


@jax.jit
def _contract_real(cores, ws):
    v = jnp.ones((1,), dtype=cores[0].dtype)
    for g, w in zip(cores, ws):
        v = v @ jnp.einsum("inj,n->ij", g, w)
    return v[0]


@jax.jit
def _contract_pair(cores, ws_r, ws_i):
    """Complex contraction of a REAL train as explicit (re, im) pair
    arithmetic — the device rendering of ztt_quad's local chain
    (dmrgg.f90:1418-1523) without a complex dtype (a form shaped for the
    first target).  Every step is two real matmuls; exactness matches complex128
    to rounding order."""
    vr = jnp.ones((1,), dtype=cores[0].dtype)
    vi = jnp.zeros((1,), dtype=cores[0].dtype)
    for g, wr, wi in zip(cores, ws_r, ws_i):
        mr = jnp.einsum("inj,n->ij", g, wr)
        mi = jnp.einsum("inj,n->ij", g, wi)
        vr, vi = vr @ mr - vi @ mi, vr @ mi + vi @ mr
    return vr[0], vi[0]


def contract(t: TT, weights: Sequence[jax.Array] | None = None) -> jax.Array:
    """Full contraction against per-mode weight vectors (local part of
    dtt_quad, dmrgg.f90:1323-1345).  weights=None sums all entries
    (sumall, tt.f90:770-814).  Compute runs under jit (one dispatch
    instead of one per op)."""
    dt = t.dtype
    if weights is not None:
        # dtype sniff must NOT touch the device: jnp.asarray(w) would
        # device_put each weight vector just to read its dtype
        import numpy as _np

        dt = jnp.result_type(dt, *[
            w.dtype if hasattr(w, "dtype") else _np.asarray(w).dtype
            for w in weights])
    if jnp.issubdtype(dt, jnp.complexfloating):
        import numpy as _np

        if not jnp.issubdtype(t.dtype, jnp.complexfloating):
            # REAL train x complex weights (the ztt_quad use every driver
            # actually performs: dtt->ztt promotion is real data) runs
            # ON DEVICE as (re, im) pair arithmetic — two real matmuls per
            # core, no complex dtype needed.  Mesh version:
            # parallel/quad.py::pcontract.
            ws = weights if weights is not None else [
                _np.ones((ni,)) for ni in t.n]
            ws = [_np.asarray(w, _np.complex128) for w in ws]
            wr = tuple(jnp.asarray(w.real) for w in ws)
            wi = tuple(jnp.asarray(w.imag) for w in ws)
            re, im = _contract_pair(tuple(t.cores), wr, wi)
            return complex(re) + 1j * complex(im)

        # COMPLEX-cored trains stay on HOST in native numpy (a form shaped
        # for the first target, without complex dtypes): the contraction is O(d r^2 n)
        # post-processing work
        v = _np.ones((1,), dtype=_np.complex128)
        for c in range(t.d):
            g = _np.asarray(t.cores[c]).astype(_np.complex128)
            if weights is None:
                m = g.sum(axis=1)
            else:
                m = _np.einsum("inj,n->ij", g, _np.asarray(weights[c], _np.complex128))
            v = v @ m
        return v[0]
    if weights is None:
        ws = tuple(jnp.ones((ni,), dt) for ni in t.n)
    else:
        ws = tuple(jnp.asarray(w, dt) for w in weights)
    return _contract_real(tuple(g.astype(dt) for g in t.cores), ws)


def sumall(t: TT) -> jax.Array:
    return contract(t, None)


def dot(a: TT, b: TT) -> jax.Array:
    """Inner product <a, b> via the two-sided core contraction
    (dtt_dot, tt.f90:1155-1175)."""
    if a.n != b.n:
        raise ValueError(f"mode mismatch: {a.n} vs {b.n}")
    x = jnp.ones((1, 1), dtype=jnp.result_type(a.dtype, b.dtype))
    for c in range(a.d):
        ga, gb = a.cores[c], b.cores[c]
        if jnp.iscomplexobj(ga):
            ga = jnp.conj(ga)
        # x (ra, rb); step: x' = sum_n ga[:,n,:]^H x gb[:,n,:]
        x = jnp.einsum("inj,ik,knl->jl", ga, x, gb)
    return x[0, 0]


def norm(a: TT) -> jax.Array:
    """Frobenius norm.  Computed stably as sqrt(<a,a>) with per-core
    rescaling to avoid overflow across long trains (the reference instead
    balances norms inside dtt_ort, tt.f90:130-198).  Scalar log/exp
    bookkeeping stays on host in full f64."""
    import math

    scale_log = 0.0
    cores = []
    for c in a.cores:
        s = float(jnp.max(jnp.abs(c)))
        if s == 0.0:
            s = 1.0
        cores.append(c / s)
        scale_log += math.log(s)
    t = TT(tuple(cores))
    return jnp.sqrt(jnp.abs(dot(t, t))) * math.exp(scale_log)


def add(a: TT, b: TT) -> TT:
    """Rank-padded sum (dtt_plus_dtt, tt.f90:928-965)."""
    if a.n != b.n:
        raise ValueError("mode mismatch")
    d = a.d
    dt = jnp.result_type(a.dtype, b.dtype)
    ra, rb = a.r, b.r
    cores = []
    for c in range(d):
        ga = a.cores[c].astype(dt)
        gb = b.cores[c].astype(dt)
        if d == 1:
            cores.append(ga + gb)
            continue
        if c == 0:
            cores.append(jnp.concatenate([ga, gb], axis=2))
        elif c == d - 1:
            cores.append(jnp.concatenate([ga, gb], axis=0))
        else:
            top = jnp.concatenate([ga, jnp.zeros((ra[c], a.n[c], rb[c + 1]), dt)], axis=2)
            bot = jnp.concatenate([jnp.zeros((rb[c], a.n[c], ra[c + 1]), dt), gb], axis=2)
            cores.append(jnp.concatenate([top, bot], axis=0))
    return TT(tuple(cores))


def scale(a: TT, c) -> TT:
    """Scalar multiply, applied to the first core (dtt_mul_dt, tt.f90:989-998)."""
    dt = jnp.result_type(a.dtype, jnp.asarray(c).dtype)
    cores = tuple(g.astype(dt) for g in a.cores)
    return TT((cores[0] * jnp.asarray(c, dtype=dt),) + cores[1:])


def hadamard(a: TT, b: TT) -> TT:
    """Elementwise product via rank Kronecker products (standard TT algebra;
    not present in the reference — provided for completeness)."""
    if a.n != b.n:
        raise ValueError("mode mismatch")
    cores = []
    for ga, gb in zip(a.cores, b.cores):
        g = jnp.einsum("inj,knl->iknjl", ga, gb)
        ra, rb = ga.shape[0], gb.shape[0]
        sa, sb = ga.shape[2], gb.shape[2]
        cores.append(g.reshape(ra * rb, ga.shape[1], sa * sb))
    return TT(tuple(cores))


def group(grp: TT, arg: TT, side: int | None = None) -> TT:
    """Block-diagonal concatenation grp <- [grp arg] (dtt_group,
    tt.f90:527-575).  side=0 shares the right border rank, side=1 the left."""
    if grp.n != arg.n:
        raise ValueError("mode mismatch")
    d = grp.d
    r, q = grp.r, arg.r
    if side is None:
        side = 0 if r[0] >= r[d] else 1
    dt = jnp.result_type(grp.dtype, arg.dtype)
    cores = []
    for c in range(d):
        ga = grp.cores[c].astype(dt)
        gb = arg.cores[c].astype(dt)
        left_shared = side == 1 and c == 0
        right_shared = side == 0 and c == d - 1
        if left_shared and right_shared:
            raise ValueError("cannot group a single-core train")
        if left_shared:
            cores.append(jnp.concatenate([ga, gb], axis=2))
        elif right_shared:
            cores.append(jnp.concatenate([ga, gb], axis=0))
        else:
            top = jnp.concatenate([ga, jnp.zeros((r[c], grp.n[c], q[c + 1]), dt)], axis=2)
            bot = jnp.concatenate([jnp.zeros((q[c], grp.n[c], r[c + 1]), dt), gb], axis=2)
            cores.append(jnp.concatenate([top, bot], axis=0))
    return TT(tuple(cores))
