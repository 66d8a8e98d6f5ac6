"""cross_batch: a FAMILY of parameterized crosses vmapped into one device
program (the vectorized form of the reference's `par` integrand argument,
dmrgg.f90:18).  Oracles: exact recovery of per-lane low-rank tensors, and
agreement with independent single-run cross() calls per lane."""

import numpy as np
import pytest
import jax.numpy as jnp

import ttcross_tpu.tt as tt
from ttcross_tpu.cross import cross, cross_batch


def _lane_cores(rng, L, d, n, r):
    """Per-lane TT cores stacked on a leading lane axis."""
    shapes = [(1 if i == 0 else r, n, r if i < d - 1 else 1)
              for i in range(d)]
    return [jnp.asarray(rng.standard_normal((L,) + s)) for s in shapes]


def _family_fun(cores):
    d = len(cores)

    def fun(ind, par):
        # par = this lane's cores (a pytree slice under vmap); evaluate
        # the exact TT entry at each index row by a small matmul chain
        v = par[0][0, ind[:, 0], :]                     # (B, r)
        for c in range(1, d):
            rows = par[c][:, ind[:, c], :]              # (r, B, r')
            v = jnp.einsum("br,rbs->bs", v, rows)
        return v[:, 0]

    return fun, d


@pytest.mark.parametrize("mode,piv", [("sequential", 1), ("sequential", -1),
                                      ("jacobi", 1)])
def test_batch_exact_recovery(rng, mode, piv):
    """Every lane of an exactly-rank-r family is recovered to round-off,
    whatever the hunt mode — the vmapped engine must keep lanes fully
    independent (no cross-lane state bleed)."""
    L, d, n, r = 3, 4, 6, 2
    cores = _lane_cores(rng, L, d, n, r)
    fun, _ = _family_fun(cores)

    res = cross_batch(fun, [n] * d, cores, max_rank=r + 2, pivoting=piv,
                      accuracy=1e-12, sweep_mode=mode, key=3)
    assert len(res) == L
    for lane in range(L):
        dense = tt.full(tt.TT(tuple(c[lane] for c in cores)))
        got = tt.full(res[lane].tt)
        err = float(jnp.max(jnp.abs(got - dense))) / float(jnp.max(jnp.abs(dense)))
        assert err < 1e-10, f"lane {lane} ({mode}, piv={piv}): err {err}"


def test_batch_matches_single_runs(rng):
    """Each lane's quadrature value agrees with an independent cross() of
    that lane's integrand (same envelope; the batched while_loop may run
    extra sweeps on early-converged lanes, which must not change exactly
    representable values)."""
    L, d, n, r = 3, 3, 5, 2
    cores = _lane_cores(rng, L, d, n, r)
    fun, _ = _family_fun(cores)
    quad = [np.abs(rng.standard_normal(n)) + 0.1 for _ in range(d)]

    res = cross_batch(fun, [n] * d, cores, max_rank=r + 1, pivoting=1,
                      accuracy=1e-12, quad=quad, key=7)
    for lane in range(L):
        single = cross(lambda ind: fun(ind, [c[lane] for c in cores]),
                       [n] * d, max_rank=r + 1, pivoting=1,
                       accuracy=1e-12, quad=quad, key=7)
        a, b = res[lane].values[-1], single.values[-1]
        assert abs(1.0 - a / b) < 1e-10, f"lane {lane}: {a} vs {b}"


def test_batch_gaussian_family_digits():
    """Analytic-truth digits across a width family of product Gaussians:
    exp(-a |x|^2) on [-8, 8]^d, truth (pi/a)^(d/2); the quadrature is
    sized so every lane is GL-resolved and the cross is exactly rank 1."""
    d, nq = 4, 65
    x, w = np.polynomial.legendre.leggauss(nq)
    x, w = 8 * x, 8 * w
    nodes = jnp.asarray(x)

    def fun(ind, a):
        xs = nodes[ind]
        return jnp.exp(-a * jnp.sum(xs * xs, axis=1))

    alphas = jnp.asarray([0.5, 1.0, 2.0])
    truths = [(np.pi / a) ** (d / 2) for a in np.asarray(alphas)]
    res = cross_batch(fun, [nq] * d, alphas, max_rank=4, pivoting=1,
                      accuracy=1e-12, quad=[w] * d, truth=truths)
    assert res.neval == sum(r.neval for r in res)
    for lane, r in enumerate(res):
        digits = -np.log10(r.errors[-1])
        assert digits > 11.5, f"lane {lane}: {digits}"
        assert r.ranks == (1, 1, 1, 1, 1)


def test_batch_validates_inputs(rng):
    fun = lambda ind, par: jnp.zeros(ind.shape[0])
    with pytest.raises(ValueError, match="lane-axis"):
        cross_batch(fun, [4] * 3, [jnp.zeros((2, 3)), jnp.zeros((3,))],
                    max_rank=2)
    with pytest.raises(ValueError, match="0-d leaf"):
        cross_batch(fun, [4] * 3, {"a": jnp.zeros((2, 3)), "b": jnp.float64(1.0)},
                    max_rank=2)
    with pytest.raises(ValueError, match="jacobi"):
        cross_batch(fun, [4] * 3, jnp.zeros((2,)), max_rank=2,
                    pivoting=-1, sweep_mode="jacobi")


def test_batch_runner_reused_across_param_values(rng, monkeypatch):
    """The compiled family runner is keyed by integrand code and parameter
    SHAPES — sweeping parameter values reuses one runner (params are
    runtime inputs of the program), and each lane still recovers its own
    tensor."""
    from ttcross_tpu.cross import batch as batch_mod

    monkeypatch.setattr(batch_mod, "_RUNNER_CACHE", {})

    L, d, n, r = 2, 3, 5, 2
    cores_a = _lane_cores(rng, L, d, n, r)
    fun, _ = _family_fun(cores_a)
    kw = dict(max_rank=r + 1, pivoting=1, accuracy=1e-12, key=5)

    res_a = cross_batch(fun, [n] * d, cores_a, **kw)
    assert len(batch_mod._RUNNER_CACHE) == 1, "one runner for the family"

    # same code + shapes, DIFFERENT parameter values -> same runner
    cores_b = [c + 0.25 * jnp.asarray(np.ones(c.shape)) for c in cores_a]
    res_b = cross_batch(fun, [n] * d, cores_b, **kw)
    assert len(batch_mod._RUNNER_CACHE) == 1

    for lane in range(L):
        dense = tt.full(tt.TT(tuple(c[lane] for c in cores_b)))
        got = tt.full(res_b[lane].tt)
        err = float(jnp.max(jnp.abs(got - dense))) / float(jnp.max(jnp.abs(dense)))
        assert err < 1e-10, f"reused-runner lane {lane}: err {err}"
    assert res_a[0].values == res_b[0].values == []


def test_batch_lane_mesh_matches_unsharded(rng):
    """Lanes sharded over a device mesh (the data-parallel axis the
    reference lacks) must reproduce the unsharded family: no cross-lane
    collectives exist, so per-lane values agree to round-off."""
    import jax
    from jax.sharding import Mesh

    L, d, n, r = 4, 3, 5, 2
    cores = _lane_cores(rng, L, d, n, r)
    fun, _ = _family_fun(cores)
    quad = [np.abs(rng.standard_normal(n)) + 0.1 for _ in range(d)]
    kw = dict(max_rank=r + 1, pivoting=1, accuracy=1e-12, quad=quad, key=11)

    base = cross_batch(fun, [n] * d, cores, **kw)
    for ndev in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("lane",))
        res = cross_batch(fun, [n] * d, cores, mesh=mesh, **kw)
        for lane in range(L):
            a, b = res[lane].values[-1], base[lane].values[-1]
            assert abs(1.0 - a / b) < 1e-12, f"ndev={ndev} lane {lane}"
            dense = tt.full(tt.TT(tuple(c[lane] for c in cores)))
            err = float(jnp.max(jnp.abs(tt.full(res[lane].tt) - dense)))
            assert err < 1e-9 * float(jnp.max(jnp.abs(dense)))

    with pytest.raises(ValueError, match="divisible"):
        mesh = Mesh(np.asarray(jax.devices()[:3]), ("lane",))
        cross_batch(fun, [n] * d, cores, mesh=mesh, **kw)
