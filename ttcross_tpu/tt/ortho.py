"""TT orthogonalization and TT-SVD rounding.

Maps dtt_ort (tt.f90:130-198), dtt_svd (tt.f90:307-368), dtt_svd0
(tt.f90:434-479), and the rank-chopping rule chop() (mat.f90:433-458).

These routines change bond ranks, so they run eagerly (shapes are data-
dependent) — exactly like the reference, where rounding is a local
single-process operation outside the distributed hot loop.  The dense
factorizations (QR / SVD) lower to XLA's library kernels.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
import numpy as np

from .types import TT

__all__ = ["orthogonalize", "svd_round", "svd_round_host", "from_dense", "chop_rank"]


def chop_rank(s: np.ndarray, tol: float | None = None, rmax: int | None = None) -> int:
    """Truncation rank: largest r with tail energy below (tol*|s|)^2, capped
    at rmax (chop, mat.f90:433-458)."""
    s = np.asarray(s)
    r = s.size
    er2 = 0.0
    if rmax is not None and rmax < r:
        er2 = float(np.dot(s[rmax:], s[rmax:]))
        r = rmax
    if tol is not None and r > 1:
        bound = tol * tol * float(np.dot(s, s))
        er = er2 + float(s[r - 1]) ** 2
        while er < bound and r > 1:
            er2 = er
            r -= 1
            er += float(s[r - 1]) ** 2
    return max(r, 1)


def orthogonalize(t: TT) -> TT:
    """Left-to-right QR sweep with geometric norm balancing across cores
    (dtt_ort, tt.f90:130-198).  After this, every core but the last is
    left-orthogonal and all cores share a common scale factor.

    Runs eagerly (rank shapes change); the scalar log/exp norm bookkeeping
    stays on host in full f64."""
    import math

    d = t.d
    cores = list(t.cores)
    lognrm = 0.0
    for k in range(d - 1):
        rc, nc, rn = cores[k].shape
        mat = cores[k].reshape(rc * nc, rn)
        q, rr = jnp.linalg.qr(mat, mode="reduced")
        nrm = float(jnp.linalg.norm(rr).real)
        if nrm != 0.0:
            rr = rr / nrm
            lognrm += math.log(nrm)
        mn = q.shape[1]
        cores[k] = q.reshape(rc, nc, mn)
        cores[k + 1] = jnp.tensordot(rr, cores[k + 1], axes=[[1], [0]])
    nrm = float(jnp.linalg.norm(cores[d - 1]).real)
    if nrm != 0.0:
        cores[d - 1] = cores[d - 1] / nrm
        lognrm += math.log(nrm)
    common = math.exp(lognrm / d)
    return TT(tuple(c * common for c in cores))


def svd_round(t: TT, tol: float = 1e-14, rmax: int | None = None) -> TT:
    """TT-SVD truncation: orthogonalize, then right-to-left SVD chop
    (dtt_svd, tt.f90:307-368)."""
    t = orthogonalize(t)
    d = t.d
    cores = list(t.cores)
    lognrm = 0.0
    for k in range(d - 1, 0, -1):
        rc, nc, rn = cores[k].shape
        mat = np.asarray(cores[k].reshape(rc, nc * rn))
        u, s, vh = np.linalg.svd(mat, full_matrices=False)
        rr = chop_rank(s, tol=tol, rmax=rmax)
        u, s, vh = u[:, :rr], s[:rr], vh[:rr]
        nrm = float(np.linalg.norm(s))
        if nrm != 0.0:
            s = s / nrm
            lognrm += np.log(nrm)
        cores[k] = jnp.asarray(vh.reshape(rr, nc, rn))
        us = jnp.asarray(u * s)
        cores[k - 1] = jnp.tensordot(cores[k - 1], us, axes=[[2], [0]])
    nrm = float(jnp.linalg.norm(cores[0]))
    if nrm != 0.0:
        cores[0] = cores[0] / nrm
        lognrm += np.log(nrm)
    common = float(np.exp(lognrm / d))
    return TT(tuple(c * common for c in cores))


def svd_round_host(cores: list, tol: float = 0.0,
                   rmax: int | None = None) -> list:
    """All-host TT-SVD truncation on plain numpy cores: the accuracy
    companion of svd_round for platforms whose device f64 is emulated
    and not correctly rounded (svd_round's orthogonalize sweep runs QR
    on the device) — used with cross/skeleton.py::reevaluate_host to
    keep the entire accuracy-critical tail of a run in host arithmetic.
    Returns numpy cores; same chop rule."""
    cs = [np.asarray(c, np.float64) for c in cores]
    d = len(cs)
    for k in range(d - 1):
        rl, nc, rr = cs[k].shape
        q, r = np.linalg.qr(cs[k].reshape(rl * nc, rr))
        cs[k] = q.reshape(rl, nc, q.shape[1])
        cs[k + 1] = np.einsum("ij,jnk->ink", r, cs[k + 1])
    for k in range(d - 1, 0, -1):
        rc, nc, rn = cs[k].shape
        u, s, vh = np.linalg.svd(cs[k].reshape(rc, nc * rn),
                                 full_matrices=False)
        rr = chop_rank(s, tol=tol, rmax=rmax)
        cs[k] = vh[:rr].reshape(rr, nc, rn)
        cs[k - 1] = np.einsum("inj,jk->ink", cs[k - 1], u[:, :rr] * s[:rr])
    return cs


def from_dense(a, n: Sequence[int] | None = None, tol: float = 1e-14, rmax: int | None = None) -> TT:
    """Compress a dense tensor into TT form by successive SVDs from the right
    (dtt_svd0, tt.f90:434-479)."""
    a = np.asarray(a)
    if n is None:
        n = a.shape
    n = tuple(int(x) for x in n)
    d = len(n)
    cores: list = [None] * d
    r_right = 1
    buf = a.reshape(int(np.prod(n)), 1, order="F").ravel(order="F")
    # Work in Fortran unfolding order to mirror the reference exactly.
    buf = a.reshape(n, order="C")
    # unfold progressively: B_{k} has shape (n0*..*n_{k-1}, n_k * r_right)
    mat = buf.reshape(int(np.prod(n[:-1])), n[-1] * 1)
    for k in range(d - 1, 0, -1):
        mm = int(np.prod(n[:k]))
        nn = n[k] * r_right
        mat = mat.reshape(mm, nn)
        u, s, vh = np.linalg.svd(mat, full_matrices=False)
        rr = chop_rank(s, tol=tol, rmax=rmax)
        u, s, vh = u[:, :rr], s[:rr], vh[:rr]
        cores[k] = jnp.asarray(vh.reshape(rr, n[k], r_right))
        mat = u * s
        r_right = rr
    cores[0] = jnp.asarray(mat.reshape(1, n[0], r_right))
    return TT(tuple(cores))
