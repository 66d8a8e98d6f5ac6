"""Distributed TT contraction over a device mesh: the JAX rendering of
dtt_quad / ztt_quad (dmrgg.f90:1261-1523).

The reference contracts each rank's owned cores against the weights and
folds the (r, r) partials with a binary-tree pairwise GEMM reduce over
MPI (stride-doubling sendrecv, dmrgg.f90:1356-1405); ztt_quad is its
complex mirror run once per weight tensor (test_crs_chf.f90 performs 32
sequential collective contractions).  Here:

  * every core is contracted into a weight matrix M_c on device and
    zero-padded to a uniform (Rm, Rm) block — zero padding is exact for
    a boundary-rank-1 chain product (the top-left block of the padded
    product IS the unpadded product),
  * a shard_map over a 1-D mesh gives each device a slab of stacked
    blocks; it folds its slab locally and joins the mesh with the same
    log2-depth stride-doubling ppermute fold as parallel.engine.pvalue,
  * complex weights run as explicit (re, im) PAIR arithmetic — two real
    matmuls per step (a form shaped for the first target, without complex dtypes),
    and a whole FAMILY of K
    weight sets (the chf driver's 32 Fourier tensors) contracts in ONE
    collective call with a leading K axis instead of K sequential
    collectives.

Exactness: pair arithmetic matches complex128 to rounding order; the
slab fold carries an exact power-of-2 balance so long chains cannot
overflow (same policy as the engine's value chain).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.dd import _exact_pow2, pow2_balance
from ..tt.types import TT

__all__ = ["pcontract"]


def _pair_balance(pr, pi, ex):
    """Scale the (re, im) pair by one EXACT power of two per K-lane."""
    m = jnp.maximum(jnp.max(jnp.abs(pr), axis=(-2, -1)),
                    jnp.max(jnp.abs(pi), axis=(-2, -1)))
    e = jnp.floor(jnp.log2(jnp.where((m > 0) & jnp.isfinite(m), m, 1.0)))
    e = jnp.where(jnp.isfinite(e), e, 0.0)
    s = _exact_pow2(-e)[..., None, None]
    return pr * s, pi * s, ex + e


def pcontract(t: TT, weights: Sequence, mesh: Mesh):
    """Contract a real TT against per-mode weight vectors on a device mesh.

    weights: list of d vectors, each (n_c,) or (K, n_c) — real or complex
    (a (K, n) weight matrix contracts K tensors at once; mixed shapes
    broadcast to the common K).  Returns a scalar or (K,) numpy array,
    complex when any weight is complex.

    Mirrors dtt_quad/ztt_quad semantics: weights=None would be sumall —
    pass explicit ones for that (the reference's no-quad branch,
    dmrgg.f90:1310-1320)."""
    if jnp.issubdtype(t.dtype, jnp.complexfloating):
        raise ValueError("pcontract shards REAL trains; complex-cored "
                         "trains contract on host (tt.ops.contract)")
    d = t.d
    ndev = int(np.prod(mesh.devices.shape))
    axis = mesh.axis_names[0]

    ws = [np.asarray(w) for w in weights]
    is_complex = any(np.iscomplexobj(w) for w in ws)
    K = max((w.shape[0] for w in ws if w.ndim == 2), default=1)
    Rm = max(max(t.r), 1)

    # --- device prologue (jitted): per-core weight matrices, zero-padded
    # and stacked; slab padding uses IDENTITY blocks (empty slab = eye)
    S = -(-d // ndev)                      # slab size (ceil)
    total = S * ndev

    @jax.jit
    def build(cores, wr, wi):
        eyes = jnp.broadcast_to(jnp.eye(Rm), (K, Rm, Rm))
        Mr, Mi = [], []
        for c in range(d):
            g = cores[c]
            mr = jnp.einsum("inj,kn->kij", g, wr[c])
            mi = jnp.einsum("inj,kn->kij", g, wi[c])
            pad = ((0, 0), (0, Rm - g.shape[0]), (0, Rm - g.shape[2]))
            Mr.append(jnp.pad(mr, pad))
            Mi.append(jnp.pad(mi, pad))
        for _ in range(total - d):
            Mr.append(eyes)
            Mi.append(jnp.zeros((K, Rm, Rm)))
        return jnp.stack(Mr), jnp.stack(Mi)    # (total, K, Rm, Rm)

    wr = tuple(jnp.asarray(np.broadcast_to(np.atleast_2d(w).real, (K, t.n[c])))
               for c, w in enumerate(ws))
    wi = tuple(jnp.asarray(np.broadcast_to(np.atleast_2d(w).imag
                                           if np.iscomplexobj(w)
                                           else np.zeros_like(np.atleast_2d(w)),
                                           (K, t.n[c])))
               for c, w in enumerate(ws))
    Mr, Mi = build(tuple(t.cores), wr, wi)

    # --- the collective fold
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(axis), P(axis)),
             out_specs=(P(), P()), check_vma=False)
    def fold(mr, mi):                      # (S, K, Rm, Rm) per device
        me = jax.lax.axis_index(axis)

        def body(carry, m):
            pr, pi, ex = carry
            nr = pr @ m[0] - pi @ m[1]
            ni = pr @ m[1] + pi @ m[0]
            return _pair_balance(nr, ni, ex), None

        init = (jnp.broadcast_to(jnp.eye(Rm), (K, Rm, Rm)),
                jnp.zeros((K, Rm, Rm)), jnp.zeros((K,)))
        (pr, pi, ex), _ = jax.lax.scan(body, init, (mr, mi))

        stride = 1
        while stride < ndev:
            perm = [(src, (src - stride) % ndev) for src in range(ndev)]
            rr = jax.lax.ppermute(pr, axis, perm)
            ri = jax.lax.ppermute(pi, axis, perm)
            rx = jax.lax.ppermute(ex, axis, perm)
            live = me + stride < ndev
            eye = jnp.broadcast_to(jnp.eye(Rm), (K, Rm, Rm))
            rr = jnp.where(live, rr, eye)
            ri = jnp.where(live, ri, jnp.zeros((K, Rm, Rm)))
            nr = pr @ rr - pi @ ri
            ni = pr @ ri + pi @ rr
            pr, pi, ex = _pair_balance(nr, ni,
                                       ex + jnp.where(live, rx, 0.0))
            stride *= 2

        # ordered product lives on device 0; broadcast its [0, 0] entry
        sc = _exact_pow2(ex)
        vr = jnp.where(me == 0, pr[:, 0, 0] * sc, 0.0)
        vi = jnp.where(me == 0, pi[:, 0, 0] * sc, 0.0)
        return (jax.lax.psum(vr, axis), jax.lax.psum(vi, axis))

    shard = NamedSharding(mesh, P(axis))
    vr, vi = fold(jax.device_put(Mr, shard), jax.device_put(Mi, shard))
    vr, vi = np.asarray(vr), np.asarray(vi)
    out = vr + 1j * vi if is_complex else vr
    squeeze = all(w.ndim == 1 for w in ws)
    return out[0] if squeeze and K == 1 else out
