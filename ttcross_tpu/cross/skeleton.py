"""Differentiable frozen-skeleton re-evaluation: parameter sensitivities
(Greeks) of TT-cross integrals via ``jax.grad``.

The reference threads an opaque parameter block ``par`` into every
integrand call (``fun(m, ind, n, par)``, dmrgg.f90:18) but can only ever
EVALUATE at one parameter value per run — sensitivities mean finite
differences of whole fresh crosses (new pivots each time, so the
difference quotient is polluted by pivot-path noise on top of costing a
full cross per probe).  A JAX-native engine can do structurally better:

1. Run the cross ONCE at a nominal parameter value and freeze its
   *skeleton* — the per-bond pivot index sets I_b, J_b that the greedy
   engine selected (decoded from the vip chains, dmrgg.f90:47-48 /
   cross/chains.py).
2. Re-evaluate the CUR interpolant's data at any parameter value θ:
   raw fibers G_c(θ) = A_θ(I_{c-1}, i_c, J_c) and pivot submatrices
   Ahat_b(θ) = A_θ(I_b, J_b), all in ONE batched integrand call, then

       val(θ) = Π_c [ G_c(θ)·w_c ] · Ahat_c(θ)^{-1}

   with differentiable linear solves.  ``jax.grad(val)(θ)`` is then the
   EXACT derivative of the interpolant — the standard frozen-skeleton
   sensitivity of cross approximations, accurate to the interpolation
   error as long as the skeleton stays informative near θ — and
   ``jax.vmap(val)`` sweeps a whole parameter family at fixed skeleton
   for the cost of fiber re-evaluations (no hunts, no pivot growth).

This is the differentiable twin of the extended-precision refinement
(cross/refine.py re-evaluates the same objects in float128; here the
re-evaluation is traced, so AD and batching transforms apply).

Integrand protocol (matches cross_batch): ``fun(ind (B, d) int32, params)
-> (B,)`` where ``params`` is any pytree of arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import solve_triangular

from .chains import pivot_index_sets

__all__ = ["Skeleton", "extract_skeleton", "skeleton_value_fn",
           "skeleton_tt_fn", "reevaluate_host", "derive_host_fun"]


def derive_host_fun(fun: Callable) -> Callable:
    """Auto-derive the host-accurate integrand twin from the traced one.

    ``cross(host_reeval=True)`` needs a host integrand ``fun_np``.  Rather
    than requiring a hand-written numpy twin, run the SAME traced
    integrand on the CPU x64 backend by jitting it under
    ``jax.default_device(cpu)``.  Returns ``fun_np(ind (B, d) int numpy)
    -> (B,) f64 numpy``, the protocol of reevaluate_host."""
    cpu = jax.devices("cpu")[0]
    jitted = jax.jit(fun)

    def fun_np(ind):
        ind = np.asarray(ind, np.int32)
        with jax.default_device(cpu):
            out = jitted(ind)
        return np.asarray(out, np.float64)

    return fun_np


@dataclass(frozen=True)
class Skeleton:
    """Frozen cross skeleton: every multi-index the interpolant samples.

    ind_all stacks the d core-fiber blocks then the d-1 pivot-submatrix
    blocks; the *_shapes lists record how to split and reshape the one
    batched integrand result.  All entries are host numpy (trace-time
    constants — the skeleton is frozen by construction)."""

    ind_all: np.ndarray                    # (B_total, d) int32
    core_shapes: tuple[tuple[int, int, int], ...]   # (r_l, n_c, r_r) per core
    ahat_shapes: tuple[int, ...]           # r per bond
    n: tuple[int, ...]
    ranks: tuple[int, ...]                 # bond ranks, length d+1

    @property
    def d(self) -> int:
        return len(self.n)

    @property
    def n_samples(self) -> int:
        return int(self.ind_all.shape[0])


def extract_skeleton(state_or_result, n: Sequence[int]) -> Skeleton:
    """Decode a completed cross into a Skeleton.

    state_or_result: a CrossResult from ``cross(..., return_state=True)``
    (its ``.state`` is used) or a CrossState directly.  n: per-mode sizes.
    """
    state = getattr(state_or_result, "state", None) or state_or_result
    if getattr(state, "vip", None) is None:
        raise ValueError(
            "extract_skeleton needs the engine state: run "
            "cross(..., return_state=True) or pass a CrossState")
    n = tuple(int(x) for x in n)
    d = len(n)
    rk = np.asarray(state.rk)
    I, J = pivot_index_sets(state.vip, rk)

    blocks: list[np.ndarray] = []
    core_shapes: list[tuple[int, int, int]] = []
    for c in range(d):
        rl, rr = int(rk[c]), int(rk[c + 1])
        pre = np.asarray(I[c - 1] if c > 0 else [()], np.int32).reshape(rl, c)
        suf = np.asarray(J[c] if c < d - 1 else [()], np.int32).reshape(rr, d - c - 1)
        ind = np.empty((rl, n[c], rr, d), np.int32)
        ind[..., :c] = pre[:, None, None, :]
        ind[..., c] = np.arange(n[c], dtype=np.int32)[None, :, None]
        ind[..., c + 1:] = suf[None, None, :, :]
        blocks.append(ind.reshape(-1, d))
        core_shapes.append((rl, n[c], rr))

    ahat_shapes: list[int] = []
    for b in range(d - 1):
        r = int(rk[b + 1])
        pre = np.asarray(I[b], np.int32).reshape(r, b + 1)
        suf = np.asarray(J[b], np.int32).reshape(r, d - b - 1)
        ind = np.empty((r, r, d), np.int32)
        ind[..., :b + 1] = pre[:, None, :]
        ind[..., b + 1:] = suf[None, :, :]
        blocks.append(ind.reshape(-1, d))
        ahat_shapes.append(r)

    return Skeleton(ind_all=np.concatenate(blocks, axis=0),
                    core_shapes=tuple(core_shapes),
                    ahat_shapes=tuple(ahat_shapes),
                    n=n, ranks=tuple(int(x) for x in rk))


@jax.custom_jvp
def _solve_right(ahat: jax.Array, m: jax.Array) -> jax.Array:
    """m @ ahat^{-1} via QR of ahat.T (a form shaped for the first target,
    whose LU was f32-only, as in cross/maxvol.py).  The derivative is a
    custom rule (below), NOT differentiation through the QR factors: the
    factor-JVP amplifies round-off ~cond(A)^2 on the near-singular
    late-rank pivot submatrices, measured 1e-2 absolute grad error on the MVN Greek
    where the solve-rule JVP matches finite differences to 1e-7."""
    q, r = jnp.linalg.qr(ahat.T)
    return solve_triangular(r, q.T @ m.T, lower=False).T


@_solve_right.defjvp
def _solve_right_jvp(primals, tangents):
    # y = m A^{-1}  =>  dy = (dm - y dA) A^{-1}: the exact solve rule,
    # linear in the tangents so reverse mode transposes through it
    ahat, m = primals
    da, dm = tangents
    y = _solve_right(ahat, m)
    return y, _solve_right(ahat, dm - y @ da)


def _split_samples(skel: Skeleton, vals: jax.Array):
    """Split the one batched integrand result back into cores G_c and
    pivot submatrices Ahat_b."""
    cores, ahats, off = [], [], 0
    for (rl, nc, rr) in skel.core_shapes:
        cnt = rl * nc * rr
        cores.append(vals[off:off + cnt].reshape(rl, nc, rr))
        off += cnt
    for r in skel.ahat_shapes:
        ahats.append(vals[off:off + r * r].reshape(r, r))
        off += r * r
    return cores, ahats


def skeleton_value_fn(fun: Callable, skel: Skeleton,
                      weights: Sequence | None = None) -> Callable:
    """Build ``vfn(params) -> scalar``: the quadrature value of the
    frozen-skeleton interpolant at parameter value ``params``.

    fun: ``fun(ind (B, d) int32, params) -> (B,)`` traced integrand.
    weights: per-mode quadrature weight vectors (w_c of length n_c);
    None sums all entries (dtt_quad's no-quad semantics,
    dmrgg.f90:1310-1320).  Complex weights are accepted (the ztt_quad
    analogue) but ``jax.grad`` needs a real-valued output — use
    holomorphic=True or split real/imag for complex contractions.

    The returned function is jit-compatible, ``jax.grad``-able in
    ``params``, and ``jax.vmap``-able for parameter sweeps.  Plain f64
    chain product — for extreme-dynamic-range integrands (Ising D/E
    tails) rescale the integrand as the reference drivers do
    (test_crs_ising.f90:135-144)."""
    ind_all = jnp.asarray(skel.ind_all)
    d = skel.d
    if weights is None:
        w_list = [jnp.ones((nc,), jnp.float64) for nc in skel.n]
    else:
        w_list = [jnp.asarray(w) for w in weights]

    def vfn(params):
        vals = fun(ind_all, params)
        cores, ahats = _split_samples(skel, vals)
        row = None
        for c in range(d):
            gw = jnp.einsum("anb,n->ab", cores[c], w_list[c])
            row = gw if row is None else row @ gw
            if c < d - 1:
                # row <- row @ Ahat_c^{-1} as a differentiable solve
                row = _solve_right(ahats[c], row)
        return row[0, 0]

    return vfn


def reevaluate_host(fun_np: Callable, skel: Skeleton) -> list:
    """Host-accurate CUR rebuild at a frozen skeleton: numpy cores of the
    interpolant with the pivot-submatrix inverses folded in.

    The refine-tier split (cross/refine.py) applied to the plain-f64
    tier: pivot SELECTION runs in the device engine (selection needs
    resolution, not precision), then the cross DATA is re-evaluated on
    host.  It was built for a device whose emulated f64 multiply capped
    a device-built train; on IEEE f64 devices it changes the digits
    little (ROADMAP Design 6).

    fun_np: ``fun_np(ind (B, d) int numpy) -> (B,) f64 numpy`` host
    integrand (e.g. ``IsingProblem.fun_np``).  Returns plain numpy cores
    (r_l, n_c, r_r); wrap in ``TT(tuple(map(jnp.asarray, cores)))`` only
    if device work is wanted — host contraction/rounding keeps the
    accuracy this function exists for (tt/ortho.py::svd_round_host)."""
    vals = np.asarray(fun_np(skel.ind_all.astype(np.int64)), np.float64)
    cores, ahats, off = [], [], 0
    for (rl, nc, rr) in skel.core_shapes:
        cores.append(vals[off:off + rl * nc * rr].reshape(rl, nc, rr))
        off += rl * nc * rr
    for r in skel.ahat_shapes:
        ahats.append(vals[off:off + r * r].reshape(r, r))
        off += r * r
    out = []
    for c, g in enumerate(cores):
        if c < len(ahats):
            rl, nc, rr = g.shape
            g = np.linalg.solve(ahats[c].T, g.reshape(-1, rr).T).T
            g = g.reshape(rl, nc, rr)
        out.append(g)
    return out


def skeleton_tt_fn(fun: Callable, skel: Skeleton) -> Callable:
    """Build ``tfn(params) -> TT``: the frozen-skeleton CUR interpolant as
    a proper TT at parameter value ``params`` (cores with the pivot-
    submatrix inverses folded in on the right, the dtt_lua convention,
    dmrgg.f90:1169-1258).  Differentiable in params — downstream tt.ops
    contractions (value/contract/dot) stay traced, so Greeks of derived
    quantities (CHF values, COS densities) flow through."""
    from ..tt.types import TT

    ind_all = jnp.asarray(skel.ind_all)
    d = skel.d

    def tfn(params):
        vals = fun(ind_all, params)
        cores, ahats = _split_samples(skel, vals)
        out = []
        for c in range(d):
            g = cores[c]
            if c < d - 1:
                rl, nc, rr = g.shape
                g = _solve_right(ahats[c], g.reshape(-1, rr)).reshape(rl, nc, rr)
            out.append(g)
        return TT(tuple(out))

    return tfn
