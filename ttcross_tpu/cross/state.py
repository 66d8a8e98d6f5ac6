"""Cross-engine state: statically padded, jit-carried.

The reference grows every per-bond array with deallocate/reallocate as ranks
increase (dmrgg.f90:602-757).  Under jit shapes must be static, so the
engine allocates everything at the padded rank R = maxrank once and
carries an active-rank vector; all updates are masked writes.  This is the
central design decision of the port (SURVEY.md §7).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class CrossState(NamedTuple):
    """Padded DMRG-greedy cross state.

    d cores, padded mode size N, padded rank R.  Bond b (0..d-2) sits
    between cores b and b+1; rk[b+1] is its active rank (rk[0]=rk[d]=1).
    """

    cores: jax.Array   # (d, R, N, R) raw sampled fibers (the reference's arg)
    colf: jax.Array    # (d, R, N, R) col factors C Ahat^-1; slot c = bond c
    rowf: jax.Array    # (d, R, N, R) row factors; slot c = bond c-1
    rk: jax.Array      # (d+1,) int32 active bond ranks
    vip: jax.Array     # (d-1, R, 4) int32 pivot chains (i, j, k, q)
    lu_c: jax.Array    # (d-1, R, R) growing-LU col borders
    lu_u: jax.Array    # (d-1, R, R) growing-LU row borders
    lu_d: jax.Array    # (d-1, R)    growing-LU pivots
    itl: jax.Array     # (d-1, R, R) maintained L^-1 (unit-lower inverse)
    itt: jax.Array     # (d-1, R, R) maintained T^-1 (upper inverse)
    amax: jax.Array    # () max |sample| seen
    pivotmax: jax.Array       # () max accepted |pivot| this sweep (-1 = none)
    pivotmin: jax.Array       # () min accepted |pivot| this sweep (-1 = none)
    pivotmax_prev: jax.Array  # () previous sweep's pivotmax
    neval: jax.Array   # () int64 count of (active) integrand evaluations
    key: jax.Array     # PRNG key
    padded: jax.Array  # () int64 ACTUAL integrand calls incl. masked padding
                       # slots — counted at every call site, not estimated,
                       # so it tracks the device work whatever the hunt
                       # structure (the honesty metric next to neval)


def pad_state(st: CrossState, R_new: int) -> CrossState:
    """Embed a CrossState padded at rank R into padding R_new > R (chunked
    rank growth: early sweeps run at small padded rank so padded fiber
    batches stay close to the reference's exact evaluation counts, then the
    state is re-embedded and the run continues at the next chunk size).

    Zero-padding everywhere except: lu_d pads with ones and the maintained
    triangular inverses pad block-diagonally with the identity ([[M, 0],
    [0, I]] keeps L^-1 / T^-1 exact for the enlarged unit-triangular
    factors)."""
    R = st.vip.shape[1]
    if R_new == R:
        return st
    if R_new < R:
        raise ValueError(f"cannot shrink padding {R} -> {R_new}")
    dR = R_new - R
    dt = st.cores.dtype

    def pad4(a):  # (d, R, N, R) -> (d, R_new, N, R_new)
        return jnp.pad(a, ((0, 0), (0, dR), (0, 0), (0, dR)))

    eye_tail = jnp.diag(jnp.where(jnp.arange(R_new) >= R, 1.0, 0.0)).astype(dt)

    def pad_inv(a):  # (d-1, R, R) -> block-diag with identity tail
        return jnp.pad(a, ((0, 0), (0, dR), (0, dR))) + eye_tail[None]

    return st._replace(
        cores=pad4(st.cores), colf=pad4(st.colf), rowf=pad4(st.rowf),
        vip=jnp.pad(st.vip, ((0, 0), (0, dR), (0, 0))),
        lu_c=jnp.pad(st.lu_c, ((0, 0), (0, dR), (0, dR))),
        lu_u=jnp.pad(st.lu_u, ((0, 0), (0, dR), (0, dR))),
        lu_d=jnp.pad(st.lu_d, ((0, 0), (0, dR)), constant_values=1.0),
        itl=pad_inv(st.itl), itt=pad_inv(st.itt),
    )


def empty_state(d: int, N: int, R: int, key, dtype=jnp.float64) -> CrossState:
    z4 = jnp.zeros((d, R, N, R), dtype)
    return CrossState(
        cores=z4, colf=z4, rowf=z4,
        rk=jnp.ones((d + 1,), jnp.int32),
        vip=jnp.zeros((d - 1, R, 4), jnp.int32),
        lu_c=jnp.zeros((d - 1, R, R), dtype),
        lu_u=jnp.zeros((d - 1, R, R), dtype),
        lu_d=jnp.ones((d - 1, R), dtype),
        itl=jnp.broadcast_to(jnp.eye(R, dtype=dtype), (d - 1, R, R)),
        itt=jnp.broadcast_to(jnp.eye(R, dtype=dtype), (d - 1, R, R)),
        amax=jnp.zeros((), dtype),
        pivotmax=jnp.full((), -1.0, dtype),
        pivotmin=jnp.full((), -1.0, dtype),
        pivotmax_prev=jnp.zeros((), dtype),
        neval=jnp.zeros((), jnp.int64),
        key=key,
        padded=jnp.zeros((), jnp.int64),
    )
