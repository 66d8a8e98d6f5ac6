"""Growing bordered-LU representation of the cross pivot-submatrix inverse.

Device redesign of the reference's compact growing-LU machinery
(d2_lug/d2_lual/d2_luar, lr.f90:98-154; incremental append in
dmrgg.f90:649-660).  The reference packs, per bond, a flat g(r*r) buffer and
applies it with sequential dgemv loops; here the same data lives in three
statically-padded arrays per bond

  lu_c[s, :s] = col-factor row at pivot s      (c_s = Cf[i_s j_s, :s])
  lu_u[s, :s] = row-factor column at pivot s   (u_s = Rf[:s, k_s q_s])
  lu_d[s]     = residual pivot value           (delta_s)

with the defining recurrences of the rank-(s+1) CUR update

  Cf[:, s] = (C_raw[:, s] - Cf[:, :s] @ u_s) / delta_s
  Rf[s, :] =  R_raw[s, :] - c_s @ Rf[:s, :]

Equivalently  C_raw = Cf @ T  and  R_raw = L @ Rf  where T is upper
triangular with T[t,s] = u_s[t], T[s,s] = delta_s and L is unit lower
triangular with L[s,t] = c_s[t].  Applying the inverse therefore becomes a
*batched triangular solve* (XLA native) instead of a rank-by-rank dgemv
chain — both the full application (dtt_lua finalization, dmrgg.f90:1169-1258)
and the incremental `from=r+1` single-column update (dmrgg.f90:701-702).

All functions are jittable with a static padded rank R and a dynamic active
rank r; inactive rows/columns are masked to the identity so solves are
exact no-ops there.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

__all__ = ["GrowingLU", "lu_empty", "lu_append", "make_T", "make_L",
           "solve_cols", "solve_rows", "apply_new_col", "apply_new_row"]


class GrowingLU(NamedTuple):
    """Per-bond growing-LU state, statically padded to R."""

    c: jax.Array  # (R, R) lower borders (col-factor rows at pivots)
    u: jax.Array  # (R, R) upper borders (row-factor columns at pivots)
    d: jax.Array  # (R,)   residual pivot values


def lu_empty(R: int, dtype=jnp.float64) -> GrowingLU:
    return GrowingLU(
        c=jnp.zeros((R, R), dtype), u=jnp.zeros((R, R), dtype),
        d=jnp.ones((R,), dtype),
    )


def lu_append(lu: GrowingLU, r, c_new: jax.Array, u_new: jax.Array, delta) -> GrowingLU:
    """Append pivot r (0-based): borders of length r (entries >= r ignored)."""
    R = lu.d.shape[0]
    mask = jnp.arange(R) < r
    return GrowingLU(
        c=jax.lax.dynamic_update_index_in_dim(lu.c, jnp.where(mask, c_new, 0.0), r, 0),
        u=jax.lax.dynamic_update_index_in_dim(lu.u, jnp.where(mask, u_new, 0.0), r, 0),
        d=jax.lax.dynamic_update_index_in_dim(lu.d, delta, r, 0),
    )


def make_T(lu: GrowingLU, r) -> jax.Array:
    """Upper-triangular T (R, R): T[t, s] = u_s[t] for t < s < r,
    diag = delta_s for s < r, identity beyond the active rank."""
    R = lu.d.shape[0]
    s_idx = jnp.arange(R)
    active = s_idx < r
    T = jnp.where((s_idx[:, None] < s_idx[None, :]) & active[None, :], lu.u.T, 0.0)
    diag = jnp.where(active, lu.d, 1.0)
    return T + jnp.diag(diag)


def make_L(lu: GrowingLU, r) -> jax.Array:
    """Unit-lower-triangular L (R, R): L[s, t] = c_s[t] for t < s < r."""
    R = lu.d.shape[0]
    s_idx = jnp.arange(R)
    active = s_idx < r
    L = jnp.where((s_idx[:, None] > s_idx[None, :]) & active[:, None], lu.c, 0.0)
    return L + jnp.eye(R, dtype=lu.c.dtype)


def solve_cols(lu: GrowingLU, r, C: jax.Array) -> jax.Array:
    """Full column-side application: Cf = C @ T^{-1}  (d2_lual from=1,
    lr.f90:124-139).  C has shape (..., R); padded columns pass through."""
    T = make_T(lu, r)
    shape = C.shape
    Cf = solve_triangular(T.T, C.reshape(-1, shape[-1]).T, lower=True)
    return Cf.T.reshape(shape)


def solve_rows(lu: GrowingLU, r, Rm: jax.Array) -> jax.Array:
    """Full row-side application: Rf = L^{-1} @ R  (d2_luar from=1,
    lr.f90:140-154).  Rm has shape (R, ...)."""
    L = make_L(lu, r)
    shape = Rm.shape
    Rf = solve_triangular(L, Rm.reshape(shape[0], -1), lower=True, unit_diagonal=True)
    return Rf.reshape(shape)


def apply_new_col(lu_prev_Cf: jax.Array, u_new: jax.Array, delta, acol: jax.Array, r) -> jax.Array:
    """Incremental `from=r+1` column update (dmrgg.f90:701): the new col-factor
    column (acol - Cf[..., :r] @ u_new) / delta with masking over :r.

    lu_prev_Cf: (..., R) existing col factor; acol: (...,) raw new column."""
    R = lu_prev_Cf.shape[-1]
    mask = (jnp.arange(R) < r).astype(lu_prev_Cf.dtype)
    corr = jnp.tensordot(lu_prev_Cf, u_new * mask, axes=[[-1], [0]])
    return (acol - corr) / delta


def apply_new_row(lu_prev_Rf: jax.Array, c_new: jax.Array, arow: jax.Array, r) -> jax.Array:
    """Incremental row update (dmrgg.f90:702): arow - c_new @ Rf[:r].

    lu_prev_Rf: (R, ...) existing row factor; arow: (...,) raw new row."""
    R = lu_prev_Rf.shape[0]
    mask = (jnp.arange(R) < r).astype(lu_prev_Rf.dtype)
    corr = jnp.tensordot(c_new * mask, lu_prev_Rf, axes=[[0], [0]])
    return arow - corr
