"""Dense linear-algebra kernels.

Maps the reference's L3 layer: mat.f90 (svd wrapper with rank chopping,
matinv, eye/laplace, power-iteration norm), ort.f90 (QR orthogonalization,
Gram-Schmidt with re-orthogonalization), lr.f90's dense routines (ACA to
tolerance lr_d2, greedy CUR d2_lrg), and trans.f90 (2-D/3-D permutations).
Dense factorizations lower to XLA's library calls; iterative routines use
lax control flow so they stay jittable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..tt.ortho import chop_rank

__all__ = [
    "svd_chopped", "matinv", "eye", "laplace", "norm2p",
    "qr_ort", "gram_schmidt", "orto_block",
    "aca", "greedy_cur", "transpose2d", "transpose3d",
    "table_lookup", "row_lookup", "batched_row_lookup",
]


def _take(a, ind, axis: int):
    # unsigned indices: a negative index is out of range (reads 0) rather
    # than counting from the end
    return jnp.take(jnp.asarray(a), jnp.asarray(ind).astype(jnp.uint32),
                    axis=axis, mode="fill", fill_value=0)


def table_lookup(table, ind):
    """out[...] = table[ind[...]] for a small 1-D table; every index
    outside [0, len(table)) reads 0."""
    return _take(table, ind, 0)


def row_lookup(mat, lin, axis: int = 0):
    """Row (axis=0) / column (axis=1) selection from a 2-D matrix:
    out[b, :] = mat[lin[b], :] (or mat[:, lin[b]]); every index outside
    [0, mat.shape[axis]) reads 0."""
    out = _take(mat, lin, axis)
    return out if axis == 0 else out.T


def batched_row_lookup(tabs, lin):
    """Batched row selection: out[b, l, :] = tabs[b, lin[b, l], :] (lin may
    also be (B,), returning (B, K)); out-of-range indices read 0."""
    lin = jnp.asarray(lin)
    single = lin.ndim == 1
    if single:
        lin = lin[:, None]
    out = jax.vmap(row_lookup)(jnp.asarray(tabs), lin)
    return out[:, 0] if single else out


def svd_chopped(a, tol: float | None = None, rmax: int | None = None):
    """SVD with rank truncation: returns (u, s, vh, err) with the chopped
    rank from the reference's tail-energy rule (svd + chop,
    mat.f90:340-458)."""
    a = np.asarray(a)
    u, s, vh = np.linalg.svd(a, full_matrices=False)
    r = chop_rank(s, tol=tol, rmax=rmax)
    err = float(np.linalg.norm(s[r:]))
    return u[:, :r], s[:r], vh[:r], err


def matinv(a, method: str = "svd", tol: float = 0.0):
    """Matrix (pseudo-)inverse via SVD with small-singular-value cutoff or
    plain LU solve (matinv, mat.f90:23-236)."""
    a = jnp.asarray(a)
    if method == "lu":
        return jnp.linalg.inv(a)
    u, s, vh = jnp.linalg.svd(a, full_matrices=False)
    cutoff = jnp.maximum(tol * jnp.max(s), 0.0)
    sinv = jnp.where(s > cutoff, 1.0 / jnp.where(s > cutoff, s, 1.0), 0.0)
    return (vh.T.conj() * sinv) @ u.T.conj()


def eye(m: int, n: int | None = None, dtype=jnp.float64):
    """Rectangular identity (eye, mat.f90:239-258)."""
    return jnp.eye(m, n or m, dtype=dtype)


def laplace(n: int, dtype=jnp.float64):
    """1-D Laplacian stencil matrix tridiag(-1, 2, -1) (laplace, mat.f90)."""
    return (2.0 * jnp.eye(n, dtype=dtype)
            - jnp.eye(n, k=1, dtype=dtype) - jnp.eye(n, k=-1, dtype=dtype))


def norm2p(a, iters: int = 32, key=0):
    """Spectral norm by power iteration on A^T A (norm2p_d,
    mat.f90:474-507); jittable."""
    a = jnp.asarray(a)
    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    v = jax.random.normal(key, (a.shape[1],), dtype=a.real.dtype)
    v = v / jnp.linalg.norm(v)

    def body(_, v):
        w = a.conj().T @ (a @ v)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-300)

    v = jax.lax.fori_loop(0, iters, body, v)
    return jnp.linalg.norm(a @ v)


def qr_ort(a):
    """Orthonormalize columns, returning (Q, R) with economy shapes
    (ort0, ort.f90:17-149 — dgeqrf/dorgqr replaced by XLA QR)."""
    return jnp.linalg.qr(jnp.asarray(a), mode="reduced")


def gram_schmidt(basis, v, passes: int = 3, tol: float = 0.5):
    """Orthogonalize vector v against orthonormal columns of `basis` with
    up-to-`passes` re-orthogonalization passes, stopping early once the
    norm stops collapsing (ort1, ort.f90:152-228).  Returns (v_ortho,
    coeffs)."""
    basis = jnp.asarray(basis)
    v = jnp.asarray(v)
    coeffs = jnp.zeros((basis.shape[1],), v.dtype)

    def body(carry):
        v, coeffs, it, prev = carry
        c = basis.conj().T @ v
        v = v - basis @ c
        nrm = jnp.linalg.norm(v)
        return v, coeffs + c, it + 1, nrm

    def cond(carry):
        v, _, it, prev = carry
        return (it < passes) & (jnp.linalg.norm(v) < tol * prev)

    c0 = basis.conj().T @ v
    v1 = v - basis @ c0
    out = jax.lax.while_loop(cond, body, (v1, c0, 1, jnp.linalg.norm(v)))
    return out[0], out[1]


def orto_block(basis, block):
    """Orthogonalize the columns of `block` against `basis` then among
    themselves (orto, ort.f90:231-361)."""
    basis = jnp.asarray(basis)
    block = jnp.asarray(block)
    block = block - basis @ (basis.conj().T @ block)
    block = block - basis @ (basis.conj().T @ block)  # one re-orthogonalization
    q, _ = jnp.linalg.qr(block, mode="reduced")
    return q


def aca(a, tol: float = 1e-12, rmax: int | None = None):
    """Adaptive cross approximation of a dense matrix to tolerance:
    returns (u, v, err) with a ~= u @ v (lr_d2, lr.f90:11-70; greedy
    column-max pivoting with rank-1 deflation)."""
    a = np.asarray(a)
    m, n = a.shape
    rmax = min(rmax or min(m, n), min(m, n))
    z = a.copy()
    nrm = np.linalg.norm(a)
    us, vs = [], []
    err = nrm
    while len(us) < rmax and err > tol * max(nrm, 1e-300):
        j = np.argmax(np.abs(z).max(axis=0))
        i = np.argmax(np.abs(z[:, j]))
        piv = z[i, j]
        if piv == 0:
            break
        u = z[:, j].copy()
        v = z[i, :] / piv
        z -= np.outer(u, v)
        us.append(u)
        vs.append(v)
        err = np.linalg.norm(z)
    u = np.stack(us, axis=1) if us else np.zeros((m, 0))
    v = np.stack(vs, axis=0) if vs else np.zeros((0, n))
    return u, v, err / max(nrm, 1e-300)


def greedy_cur(a, r: int):
    """Greedy rank-r CUR by global residual max: returns (u, v, rows, cols)
    with a ~= u @ v (d2_lrg, lr.f90:73-96)."""
    a = np.asarray(a)
    m, n = a.shape
    e = a.copy()
    u = np.zeros((m, r))
    v = np.zeros((r, n))
    rows, cols = [], []
    for p in range(r):
        i, j = np.unravel_index(np.argmax(np.abs(e)), e.shape)
        rows.append(int(i))
        cols.append(int(j))
        u[:, p] = e[:, j]
        v[p, :] = e[i, :] / e[i, j]
        e -= np.outer(u[:, p], v[p, :])
    return u, v, rows, cols


def transpose2d(a):
    """2-D transpose (trans.f90:19-70; a relayout XLA handles)."""
    return jnp.asarray(a).T


_PRM3 = {1: (0, 1, 2), 2: (0, 2, 1), 3: (1, 0, 2), 4: (2, 1, 0), 5: (1, 2, 0), 6: (2, 0, 1)}


def transpose3d(p: int, a):
    """The six 3-D permutations keyed like the reference's prm3 table
    (d3_trans + prm3, trans.f90:72-240)."""
    return jnp.transpose(jnp.asarray(a), _PRM3[p])


def pow2_balance_mats(x):
    """Batched pow2_balance over a (K, R, R) stack: per-matrix EXACT
    power-of-2 rescale.  Returns (x * 2^-e, e) with e (K,) and
    max|x * 2^-e| per matrix near 1 (zero / non-finite matrices pass
    through with e = 0)."""
    from .dd import _exact_pow2

    m = jnp.max(jnp.abs(x), axis=(-2, -1))
    e = jnp.floor(jnp.log2(jnp.where((m > 0) & jnp.isfinite(m), m, 1.0)))
    e = jnp.where(jnp.isfinite(e), e, 0.0)
    return x * _exact_pow2(-e)[..., None, None], e


def balanced_matmul_chain(mats):
    """Ordered product of a (K, R, R) matrix stack as a log2(K)-depth
    pairwise tree — identity-padded to a power of two, one batched
    matmul + exact power-of-2 rebalance per level — instead of a K-step
    serial chain.  Returns (P, e) with  mats[0] @ ... @ mats[K-1] =
    P * 2^e  and max|P| ~ 1: long chains (d ~ 256+) overflow the raw
    partial products (see engine.value_fn), so the exponent rides
    separately.  Matrix association is exact; only rounding order
    changes (pairwise is O(log K) rounding growth vs O(K) serial).
    A serial chain of K dependent small matmuls is latency-bound; the
    tree is log2(K) batched kernels."""
    K, R = mats.shape[0], mats.shape[-1]
    mats, ex = pow2_balance_mats(mats)
    P = 1 << max(K - 1, 1).bit_length()        # next power of two >= K
    if P > K:
        pad_eye = jnp.broadcast_to(jnp.eye(R, dtype=mats.dtype),
                                   (P - K, R, R))
        mats = jnp.concatenate([mats, pad_eye], axis=0)
        ex = jnp.concatenate([ex, jnp.zeros((P - K,), ex.dtype)])
    while mats.shape[0] > 1:
        # broadcast-multiply + reduce-sum rather than einsum, a form
        # shaped for the first target, whose batched f64 dot_general was
        # serial; R is small (~10-25) so the (k, R, R, R) intermediate
        # stays tiny.
        prod = jnp.sum(mats[0::2][:, :, :, None] * mats[1::2][:, None],
                       axis=2)
        prod, e = pow2_balance_mats(prod)
        mats, ex = prod, ex[0::2] + ex[1::2] + e
    return mats[0], ex[0]
