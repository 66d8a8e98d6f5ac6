"""Extended-precision refinement of a completed cross.

The role of the reference's multiprecision tier (mptt_dmrgg + mptt_quad,
dmrggmp.f90): compute the cross interpolant and its quadrature beyond f64.
Split: pivot SELECTION stays in the f64 device engine (selection
needs resolution, not precision), then the cross DATA is re-evaluated at the
selected pivot chains in __float128 (native host kernels) and the
interpolant quadrature

  val = e0  prod_c [ G_c(w) Ahat_c^{-1} ]

is evaluated entirely in quad precision (G_c = raw fibers at the chains,
Ahat_c = pivot submatrices, both from the extended-precision integrand).
The result's accuracy is then limited by the quadrature rule (use the dd
Gauss-Legendre rules from native.gauss_legendre_dd) and the rank
truncation, not by f64 round-off.

fun_dd protocol: fun_dd(ind (B, d) int64) -> (hi (B,), lo (B,)) numpy.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .chains import pivot_index_sets
from .state import CrossState

__all__ = ["refine_dd"]


def refine_dd(state: CrossState, n, fun_dd, weights_hi, weights_lo=None):
    """Re-evaluate the crossed tensor at its pivot chains in extended
    precision and return the quadrature value as a double-double (hi, lo).

    state: final engine state (cross(..., return_state=True)).
    n: per-mode sizes.  fun_dd: extended-precision integrand.
    weights_*: per-mode quadrature weight vectors as dd pairs."""
    n = [int(x) for x in n]
    d = len(n)
    rk = np.asarray(state.rk)
    if weights_lo is None:
        weights_lo = [np.zeros(ni) for ni in n]
    I, J = pivot_index_sets(state.vip, rk)

    # raw cores G_c = A(I_{c-1}, j, J_c) at the pivot chains
    cores_hi, cores_lo = [], []
    neval = 0
    for c in range(d):
        rl = int(rk[c])
        rr = int(rk[c + 1])
        pre = I[c - 1] if c > 0 else [()]
        suf = J[c] if c < d - 1 else [()]
        ind = np.zeros((rl * n[c] * rr, d), dtype=np.int64)
        row = 0
        for a in range(rl):
            for j in range(n[c]):
                for b in range(rr):
                    ind[row, :] = pre[a] + (j,) + suf[b]
                    row += 1
        hi, lo = fun_dd(ind)
        neval += row
        cores_hi.append(hi.reshape(rl, n[c], rr))
        cores_lo.append(lo.reshape(rl, n[c], rr))

    # pivot submatrices Ahat_b = A(I_b, J_b)
    ahat_hi, ahat_lo = [], []
    for b in range(d - 1):
        r = int(rk[b + 1])
        ind = np.zeros((r * r, d), dtype=np.int64)
        row = 0
        for a in range(r):
            for bb in range(r):
                ind[row, :] = I[b][a] + J[b][bb]
                row += 1
        hi, lo = fun_dd(ind)
        neval += row
        ahat_hi.append(hi.reshape(r, r))
        ahat_lo.append(lo.reshape(r, r))

    hi, lo = native.cross_value_dd(rk, n, cores_hi, cores_lo,
                                   ahat_hi, ahat_lo, weights_hi, weights_lo)
    return hi, lo, neval
