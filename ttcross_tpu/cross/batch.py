"""Batched parameterized cross: many TT-cross runs in ONE device program.

The reference threads an opaque parameter block `par` from the driver
through the engine into every integrand call (`fun(m, ind, n, par)`,
dmrgg.f90:18; e.g. the Ising node tables ride in `par`,
test_crs_ising.f90:149-153).  Running a FAMILY of integrals — option
prices across strikes, MVN masses across correlations, an Ising scan over
quadrature sizes — means launching the binary once per parameter value,
paying the full per-run latency each time.

`cross_batch` is the device upgrade of that contract: the integrand
takes the parameter explicitly (`fun(ind[B, d], par) -> (B,)`), and the
WHOLE fused cross engine (init + multi-sweep while_loop + LU finalize,
engine.make_full_fn) is `jax.vmap`-ed over a leading lane axis of `par`.
All L lanes hunt pivots, grow their LU borders, and contract their
quadrature values inside one compiled executable:

- every (r x n)-sized hunt/accept op becomes an (L, r, n) op — these
  small ops are LATENCY-bound, so L lanes can cost nearly the same wall
  time as one;
- one dispatch + one packed transfer for the whole family instead of L
  round trips.

Semantics under vmap: `lax.while_loop`'s stop condition is lifted to
"all lanes done" — a lane that has already hit its strike-3 stop keeps
sweeping (harmless: acceptance thresholds and the rank cap still gate
every update) until the slowest lane converges or max_sweeps is reached.
Per-lane sweep telemetry is exact; the shared sweep count is the max over
lanes.  Each lane draws its own PRNG stream (jax.random.split of `key`),
so lottery paths decorrelate across lanes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import precision_thresholds
from ..tt.types import TT
from .engine import CrossConfig, CrossResult, _values_errors, make_engine

__all__ = ["cross_batch", "BatchCrossResult"]


@dataclass
class BatchCrossResult:
    """Results of a batched cross: one CrossResult per parameter lane.

    lanes[l].tt is lane l's solved train; neval/time are family totals
    (the lanes share every device call, so per-lane timing is not
    separable — each lane's CrossResult carries the family wall time)."""

    lanes: list[CrossResult]
    neval: int            # total integrand evaluations across the family
    time: float           # wall time of the single fused run
    sweeps: int           # shared sweep count (max over lanes by design)

    def __len__(self):
        return len(self.lanes)

    def __getitem__(self, i):
        return self.lanes[i]

    def __iter__(self):
        return iter(self.lanes)


_RUNNER_CACHE: dict = {}
_RUNNER_PINS: list = []  # keep integrand objects alive so id() keys stay valid


def _get_batch_runner(fun, cfg, max_sweeps, with_quad, accuracy,
                      params, mesh=None):
    """Memoized jit(vmap(full cross)) — repeated cross_batch calls with the
    same integrand/config/lane-shape reuse the compiled executable
    (get_engine's memoization scheme)."""
    shapes = tuple((tuple(np.shape(leaf)), str(jnp.result_type(leaf)))
                   for leaf in jax.tree_util.tree_leaves(params))
    treedef = jax.tree_util.tree_structure(params)
    target = getattr(fun, "__self__", fun)
    key = (id(target), getattr(fun, "__name__", None), cfg,
           max_sweeps, with_quad, accuracy, shapes, str(treedef),
           id(mesh) if mesh is not None else None)
    runner = _RUNNER_CACHE.get(key)
    if runner is None:
        def run_one(k, w, par):
            # the engine is BUILT inside the vmap trace so every integrand
            # call site closes over this lane's `par` tracer; make_engine
            # is pure Python closure assembly — per-trace cost is nil
            kit = make_engine(lambda ind: fun(ind, par), cfg)
            return kit.make_full_fn(max_sweeps, with_quad, accuracy)(k, w)

        runner = jax.jit(jax.vmap(run_one, in_axes=(0, None, 0)))
        _RUNNER_PINS.append(target)
        _RUNNER_CACHE[key] = runner
    return runner


def cross_batch(
    fun: Callable,
    n: Sequence[int],
    params,
    max_rank: int = 20,
    accuracy: float | None = None,
    pivoting: int = 1,
    quad: Sequence | None = None,
    truth=None,
    key: int | jax.Array = 0,
    dtype=jnp.float64,
    verbose: bool = False,
    max_sweeps: int | None = None,
    small_element: float | None = None,
    small_pivot: float | None = None,
    sweep_mode: str = "sequential",
    mesh=None,
) -> BatchCrossResult:
    """Cross-interpolate a FAMILY of black-box tensors in one device program.

    fun: parameterized batched integrand `fun(ind (B, d) int32, par) ->
    (B,)`, traceable in both arguments (the vectorized form of the
    reference's `fun(m, ind, n, par)` callback, dmrgg.f90:18).
    params: pytree of family parameters; every leaf carries a leading
    lane axis of size L (lane l's integrand sees `leaf[l]`).
    truth: optional analytic value — scalar (shared) or length-L sequence.
    Other arguments as `cross()` (shared across lanes).

    mesh: optional 1-axis `jax.sharding.Mesh` — lanes are SHARDED over
    the mesh axis (L divisible by the device count), each device running
    its lane block of the whole fused engine with ZERO inter-device
    collectives: a data-parallel axis the reference does not have
    (SURVEY §2.5 — its only distributed strategy splits the TT chain).
    Composable in principle with the bond-mesh engine for 2-D
    (lane x bond) scaling.

    Returns a BatchCrossResult of L CrossResults.  Post-passes that
    reshape individual runs (oversample / refine_sweeps / rank_chunks /
    rank_caps / state passing) are per-lane concepts — run `cross()` on a
    lane's parameters if you need them."""
    n = tuple(int(x) for x in n)
    d = len(n)
    if d < 2:
        raise ValueError("cross_batch requires d >= 2")
    if max_rank < 2:
        raise ValueError("max_rank must be >= 2")
    if sweep_mode not in ("sequential", "jacobi"):
        raise ValueError(f"unknown sweep_mode {sweep_mode!r}")
    if sweep_mode == "jacobi" and int(pivoting) < 0:
        raise ValueError("sweep_mode='jacobi' requires pivoting >= 0")

    leaves = jax.tree_util.tree_leaves(params)
    if not leaves:
        raise ValueError("params must contain at least one array leaf")
    for leaf in leaves:
        if np.ndim(leaf) == 0:
            raise ValueError("every params leaf needs a leading lane axis; "
                             "got a 0-d leaf (broadcast shared values to "
                             "(L, ...) or close over them in fun)")
    L = int(np.shape(leaves[0])[0])
    for leaf in leaves:
        if int(np.shape(leaf)[0]) != L:
            raise ValueError("every params leaf needs the same leading "
                             f"lane-axis size; got {np.shape(leaf)[0]} vs {L}")

    se, sp = precision_thresholds(dtype)
    if small_element is not None:
        se = float(small_element)
    if small_pivot is not None:
        sp = float(small_pivot)
    cfg = CrossConfig(d=d, n=n, N=max(n), R=max_rank, piv=int(pivoting),
                      small_element=se, small_pivot=sp,
                      jacobi=sweep_mode == "jacobi")

    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    keys = jax.random.split(key, L)

    with_quad = quad is not None
    if with_quad:
        w_np = np.zeros((d, cfg.N))
        for c in range(d):
            w_np[c, : n[c]] = np.asarray(quad[c])
        w = jnp.asarray(w_np)
    else:
        w = jnp.zeros((d, cfg.N))
    if max_sweeps is None:
        max_sweeps = max_rank - 1
    S = max_sweeps + 1

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        if len(mesh.axis_names) != 1:
            raise ValueError("cross_batch mesh must have exactly one axis")
        ndev = mesh.devices.size
        if L % ndev:
            raise ValueError(f"lane count {L} must be divisible by the "
                             f"mesh's {ndev} devices")
        ax = mesh.axis_names[0]

        def _shard(a):
            a = jnp.asarray(a)
            spec = PartitionSpec(ax, *([None] * (a.ndim - 1)))
            return jax.device_put(a, NamedSharding(mesh, spec))

        keys = _shard(keys)
        params = jax.tree_util.tree_map(_shard, params)

    runner = _get_batch_runner(fun, cfg, max_sweeps, with_quad, accuracy,
                               params, mesh=mesh)

    t0 = time.perf_counter()
    solved, packed = runner(keys, w, params)
    solved = jax.block_until_ready(solved)
    packed = np.asarray(packed)           # (L, P)
    wall = time.perf_counter() - t0

    if truth is None:
        truths = [None] * L
    elif np.ndim(truth) == 0:
        truths = [float(truth)] * L
    else:
        truths = [float(x) for x in truth]
        if len(truths) != L:
            raise ValueError(f"truth must be scalar or length {L}")

    lanes = []
    total_neval = 0
    sweeps = 0
    for lane in range(L):
        p = packed[lane]
        vals = p[:S]
        pmax = p[S:2 * S]
        nev = p[2 * S:3 * S].astype(np.int64)
        rk = p[3 * S:3 * S + d + 1].astype(np.int64)
        last_it = int(p[-3])
        neval = int(p[-2])
        padded = int(p[-1])
        values, errors = _values_errors(vals, last_it, truths[lane], with_quad)

        from ..utils.metrics import history_from_run

        history = history_from_run(last_it, vals, pmax, nev, truths[lane],
                                   with_quad)
        tt = TT(tuple(solved[lane, c, : rk[c], : n[c], : rk[c + 1]]
                      for c in range(d)))
        lanes.append(CrossResult(
            tt=tt, neval=neval, sweeps=last_it,
            ranks=tuple(int(x) for x in rk), values=values, errors=errors,
            time=wall, converged=accuracy is not None and last_it < max_sweeps,
            history=history, padded_evals=padded))
        total_neval += neval
        sweeps = max(sweeps, last_it)
        if verbose:
            tail = ""
            if errors:
                tail = f" err {errors[-1]:9.3e}"
            if values:
                tail += f" val {values[-1]:.14e}"
            print(f"lane {lane:3d}: sweeps {last_it:3d} ranks "
                  f"{lanes[-1].ranks} n_evals {neval:9d}{tail}")

    return BatchCrossResult(lanes=lanes, neval=total_neval, time=wall,
                            sweeps=sweeps)
