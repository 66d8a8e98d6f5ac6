"""Distributed engine tests on the virtual 8-device CPU mesh (the
`mpirun -np N` analogue, SURVEY.md §4 item 6)."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import ttcross_tpu.tt as tt
from ttcross_tpu.parallel import cross_parallel, share


def test_share_blocks():
    own = share(10, 4)
    assert list(own) == [0, 3, 6, 8, 10]
    assert list(share(5, 5)) == [0, 1, 2, 3, 4, 5]
    with pytest.raises(ValueError):
        share(3, 4)


def test_parallel_exact_recovery(rng):
    """4-device bond mesh recovers an exact-rank tensor; same integrand /
    different decomposition must reach the same accuracy as single-chip."""
    d, n = 5, 5
    ranks = (1, 2, 2, 2, 2, 1)
    cores = [rng.standard_normal((ranks[i], n, ranks[i + 1])) for i in range(d)]
    T = tt.from_cores(cores)
    dense = np.asarray(tt.full(T))

    def fun(ind):
        return tt.gather(T, ind)

    mesh = Mesh(np.asarray(jax.devices()[:4]), ("bond",))
    w = [np.full(n, 1.0 / n)] * d
    res = cross_parallel(fun, [n] * d, max_rank=3, pivoting=1, accuracy=1e-12,
                         quad=w, truth=float(dense.mean()), mesh=mesh)
    approx = np.asarray(tt.full(res.tt))
    assert np.abs(approx - dense).max() < 1e-10
    # per-sweep distributed quadrature value converges to the dense mean
    assert res.errors[-1] < 1e-11


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    ge.dryrun_multichip(4)


def test_parallel_ragged_modes(rng):
    """Per-mode sizes may differ on the mesh too."""
    ns = (5, 7, 6, 5, 6)
    ranks = (1, 2, 2, 2, 2, 1)
    cores = [rng.standard_normal((ranks[i], n, ranks[i + 1]))
             for i, n in enumerate(ns)]
    T = tt.from_cores(cores)
    dense = np.asarray(tt.full(T))

    def fun(ind):
        return tt.gather(T, ind)

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("bond",))
    res = cross_parallel(fun, ns, max_rank=3, pivoting=1, accuracy=1e-12, mesh=mesh)
    assert res.tt.n == ns
    approx = np.asarray(tt.full(res.tt))
    assert np.abs(approx - dense).max() < 1e-10


def test_parallel_mybonds(rng):
    """Caller-provided slab boundaries (the reference's mybonds argument,
    dmrgg.f90:22, 120-131) replace the block share distribution."""
    d, n = 6, 5
    ranks = (1, 2, 3, 2, 2, 2, 1)
    cores = [rng.standard_normal((ranks[i], n, ranks[i + 1])) for i in range(d)]
    T = tt.from_cores(cores)
    dense = np.asarray(tt.full(T))

    def fun(ind):
        return tt.gather(T, ind)

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("bond",))
    # uneven custom slabs: device 0 owns bond 0, device 1 owns bonds 1..4
    res = cross_parallel(fun, [n] * d, max_rank=4, pivoting=1, accuracy=1e-12,
                         mesh=mesh, mybonds=[0, 1, 5])
    approx = np.asarray(tt.full(res.tt))
    assert np.abs(approx - dense).max() < 1e-10
    with pytest.raises(ValueError):
        cross_parallel(fun, [n] * d, max_rank=4, mesh=mesh, mybonds=[0, 5])


@pytest.mark.parametrize("pivoting", [0, -1])
def test_parallel_pivot_modes(rng, pivoting):
    """Lottery-only and full pivoting also work on the mesh."""
    d, n = 5, 5
    ranks = (1, 2, 2, 2, 2, 1)
    cores = [rng.standard_normal((ranks[i], n, ranks[i + 1])) for i in range(d)]
    T = tt.from_cores(cores)
    dense = np.asarray(tt.full(T))

    def fun(ind):
        return tt.gather(T, ind)

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("bond",))
    res = cross_parallel(fun, [n] * d, max_rank=3, pivoting=pivoting,
                         accuracy=1e-12, mesh=mesh)
    approx = np.asarray(tt.full(res.tt))
    assert np.abs(approx - dense).max() < 1e-10


def _dd_digits(value, tru_str):
    from decimal import Decimal, getcontext

    getcontext().prec = 60
    got = Decimal(value[0]) + Decimal(value[1])
    rel = abs(1 - got / Decimal(tru_str))
    return float(-rel.log10()) if rel != 0 else 60.0


@pytest.mark.slow
def test_parallel_dd_matches_single_device():
    """Distributed dd cross (parallel/engine_dd.py, the mp engine's MPI
    path, dmrggmp.f90:518-629): 2-device mesh matches the single-device dd
    engine's accuracy envelope on Ising C_4."""
    from ttcross_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    from ttcross_tpu.apps.ising import make_ising_dd
    from ttcross_tpu.apps.truths import ISING_C_STR
    from ttcross_tpu.cross.engine_dd import cross_dd
    from ttcross_tpu.parallel import cross_dd_parallel
    from ttcross_tpu.parallel.mesh import bond_mesh

    prob, fun_dd, wh, wl = make_ising_dd(m=4, n=33)
    single = cross_dd(fun_dd, [prob.n] * prob.d, wh, wl, max_rank=12, pivoting=1)
    par = cross_dd_parallel(fun_dd, [prob.n] * prob.d, wh, wl, max_rank=12,
                            pivoting=1, mesh=bond_mesh(jax.devices()[:2]))
    ds = _dd_digits(single.value, ISING_C_STR[4])
    dp = _dd_digits(par.value, ISING_C_STR[4])
    assert dp >= 11, (dp, ds)
    assert abs(dp - ds) < 4, (dp, ds)   # same envelope, stochastic pivots
    assert par.ranks == single.ranks


def test_parallel_dd_per_sweep_value_telemetry(capsys):
    """cross_dd_parallel(verbose=True) prints the per-sweep dd quadrature
    value with err (dmrggmp.f90:655-672, distributed via an ordered
    cross-device fold); the last in-loop value converges to the finalized
    train's quadrature value."""
    from ttcross_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    from ttcross_tpu.apps.ising import make_ising_dd
    from ttcross_tpu.apps.truths import ISING_C_STR
    from ttcross_tpu.parallel import cross_dd_parallel
    from ttcross_tpu.parallel.mesh import bond_mesh

    prob, fun_dd, wh, wl = make_ising_dd(m=4, n=17)
    res = cross_dd_parallel(fun_dd, [prob.n] * prob.d, wh, wl, max_rank=8,
                            pivoting=1, mesh=bond_mesh(jax.devices()[:2]),
                            verbose=True, truth=ISING_C_STR[4])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "err" in ln and "val" in ln]
    assert len(lines) >= 5
    last_val = float(lines[-1].split("val")[-1])
    assert abs(last_val - (res.value[0] + res.value[1])) < 1e-12


@pytest.mark.slow
def test_parallel_dd_8dev_long_chain():
    """8-device dd cross of Ising C_16 (d=15): the full mesh works beyond
    toy sizes (measured 8.9 digits at rank 10 / n=17)."""
    from ttcross_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    from ttcross_tpu.apps.ising import make_ising_dd
    from ttcross_tpu.apps.truths import ISING_C_STR
    from ttcross_tpu.parallel import cross_dd_parallel
    from ttcross_tpu.parallel.mesh import bond_mesh

    prob, fun_dd, wh, wl = make_ising_dd(m=16, n=17)
    res = cross_dd_parallel(fun_dd, [prob.n] * prob.d, wh, wl, max_rank=10,
                            pivoting=1, mesh=bond_mesh(jax.devices()[:8]))
    assert _dd_digits(res.value, ISING_C_STR[16]) >= 7


def test_parallel_oversample(rng):
    """cross_parallel(oversample=k): cross-and-round on the mesh."""
    d, n = 5, 7
    ranks = (1, 2, 3, 3, 2, 1)
    cores = [rng.standard_normal((ranks[i], n, ranks[i + 1])) for i in range(d)]
    T = tt.from_cores(cores)
    dense = np.asarray(tt.full(T))

    def fun(ind):
        return tt.gather(T, ind)

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("bond",))
    res = cross_parallel(fun, [n] * d, max_rank=3, pivoting=1,
                         accuracy=1e-12, mesh=mesh, oversample=2)
    assert max(res.ranks) <= 3
    approx = np.asarray(tt.full(res.tt))
    assert np.abs(approx - dense).max() < 1e-10

    # oversample composes with the maxvol replacement post-pass on the
    # mesh like the single-device path (cross at R+k, refine, round)
    res_c = cross_parallel(fun, [n] * d, max_rank=3, pivoting=1,
                           accuracy=1e-12, mesh=mesh, oversample=2,
                           refine_sweeps=1,
                           quad=[np.full(n, 1.0 / n)] * d)
    assert max(res_c.ranks) <= 3
    assert np.abs(np.asarray(tt.full(res_c.tt)) - dense).max() < 1e-10


def test_accchk_on_mesh(rng):
    """Mesh-sharded accchk matches the single-device statistics (the
    reference shards the accchk lottery over MPI ranks the same way,
    dmrgg.f90:1092-1096)."""
    from ttcross_tpu.cross.accchk import accchk

    d, n = 4, 6
    ranks = (1, 2, 2, 2, 1)
    cores = [rng.standard_normal((ranks[i], n, ranks[i + 1])) for i in range(d)]
    T = tt.from_cores(cores)

    def fun(ind):
        return tt.gather(T, ind) + 1e-9 * jax.numpy.sin(ind.sum(axis=1).astype(float))

    mesh = Mesh(np.asarray(jax.devices()[:4]), ("bond",))
    ref = accchk(T, fun, nlot=4096, key=7)
    par = accchk(T, fun, nlot=4096, key=7, mesh=mesh)
    assert par["einf"] == ref["einf"]
    assert par["ainf"] == ref["ainf"]
    assert par["worst_index"] == ref["worst_index"]
    assert abs(par["efro"] - ref["efro"]) <= 1e-12 * max(1.0, ref["efro"])
    assert abs(par["afro"] - ref["afro"]) <= 1e-12 * max(1.0, ref["afro"])


@pytest.mark.parametrize("ndev", [2, 4])
def test_parallel_jacobi_exact_recovery(rng, ndev):
    """Slab-level Jacobi: each device hunts its own slab's bonds batched,
    acceptance runs replicated (the jacobi rendering of the reference's
    dimension-parallel mode, dmrgg.f90:120-131)."""
    d, n = 6, 7
    ranks = (1, 2, 3, 3, 3, 2, 1)
    cores = [rng.standard_normal((ranks[i], n, ranks[i + 1])) for i in range(d)]
    T = tt.from_cores(cores)
    dense = np.asarray(tt.full(T))

    def fun(ind):
        return tt.gather(T, ind)

    mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("bond",))
    res = cross_parallel(fun, [n] * d, max_rank=5, pivoting=1,
                         accuracy=1e-12, mesh=mesh, sweep_mode="jacobi")
    approx = np.asarray(tt.full(res.tt))
    assert np.abs(approx - dense).max() < 1e-10 * max(1, np.abs(dense).max())
    assert res.neval > 0 and res.padded_evals >= res.neval


def test_parallel_jacobi_matches_single_device_quality(rng):
    """2-device slab jacobi reaches the same interpolation quality as the
    single-device jacobi sweep on a rank-deficient target."""
    from ttcross_tpu.cross import cross

    d, n = 5, 6
    ranks = (1, 2, 2, 2, 2, 1)
    cores = [rng.standard_normal((ranks[i], n, ranks[i + 1])) for i in range(d)]
    T = tt.from_cores(cores)
    dense = np.asarray(tt.full(T))

    def fun(ind):
        return tt.gather(T, ind)

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("bond",))
    res_p = cross_parallel(fun, [n] * d, max_rank=4, pivoting=1,
                           accuracy=1e-12, mesh=mesh, sweep_mode="jacobi")
    res_s = cross(fun, [n] * d, max_rank=4, pivoting=1, accuracy=1e-12,
                  sweep_mode="jacobi")
    err_p = np.abs(np.asarray(tt.full(res_p.tt)) - dense).max()
    err_s = np.abs(np.asarray(tt.full(res_s.tt)) - dense).max()
    assert err_p < 1e-10
    assert err_s < 1e-10


def test_parallel_maxvol_single_device_matches_sequential(rng):
    """maxvol_refine_parallel on a 1-device mesh walks exactly the
    sequential iteration (same init, same deterministic exchanges); its
    cores come from the frozen-table emit pass, which must agree with
    visit_rl's free cores up to solve roundoff.  The emit pass costs one
    extra half-sweep of evaluations."""
    from ttcross_tpu.cross.maxvol import maxvol_refine
    from ttcross_tpu.parallel.maxvol import maxvol_refine_parallel

    d, n, r = 4, 8, 3
    cores = [rng.standard_normal((1 if c == 0 else r, n,
                                  1 if c == d - 1 else r)) for c in range(d)]
    T = tt.from_cores(cores)
    dense = np.asarray(tt.full(T))

    def fun(ind):
        return tt.gather(T, ind)

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("bond",))
    seq = maxvol_refine(fun, [n] * d, ranks=r, sweeps=2, key=7)
    par = maxvol_refine_parallel(fun, [n] * d, ranks=r, sweeps=2, key=7,
                                 mesh=mesh)
    for cs, cp in zip(seq.tt.cores, par.tt.cores):
        np.testing.assert_allclose(np.asarray(cs), np.asarray(cp),
                                   atol=1e-9)
    assert par.neval > seq.neval          # + the emit-core pass
    assert par.padded_evals > seq.padded_evals
    err = np.abs(np.asarray(tt.full(par.tt)) - dense).max()
    assert err < 1e-10 * np.abs(dense).max()


@pytest.mark.parametrize("ndev", [2, 4])
def test_parallel_maxvol_exact_recovery(rng, ndev):
    """Slab-parallel maxvol (block-Jacobi across slab boundaries) still
    recovers an exact-rank tensor to machine precision."""
    from ttcross_tpu.parallel.maxvol import maxvol_refine_parallel

    d, n, r = 6, 7, 3
    cores = [rng.standard_normal((1 if c == 0 else r, n,
                                  1 if c == d - 1 else r)) for c in range(d)]
    T = tt.from_cores(cores)
    dense = np.asarray(tt.full(T))

    def fun(ind):
        return tt.gather(T, ind)

    mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("bond",))
    res = maxvol_refine_parallel(fun, [n] * d, ranks=r, sweeps=3, key=1,
                                 mesh=mesh)
    err = np.abs(np.asarray(tt.full(res.tt)) - dense).max()
    assert err < 1e-10 * np.abs(dense).max(), err
    assert res.ranks == (1,) + (r,) * (d - 1) + (1,)
    assert res.neval > 0 and res.padded_evals >= res.neval


def test_parallel_refine_sweeps_beats_greedy():
    """cross_parallel(refine_sweeps=1) seeds the distributed maxvol with
    the distributed greedy pivots and must not lose quality (the
    sequential analogue gains ~1 digit on MVN, test_maxvol.py)."""
    from ttcross_tpu.apps import make_mvn

    prob = make_mvn(d=5, n=33)
    quad = [prob.quad_weights] * prob.d
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("bond",))
    g = cross_parallel(prob.fun, [prob.n] * prob.d, max_rank=10,
                       pivoting=1, quad=quad, truth=prob.truth, key=3,
                       mesh=mesh)
    r = cross_parallel(prob.fun, [prob.n] * prob.d, max_rank=10,
                       pivoting=1, quad=quad, truth=prob.truth, key=3,
                       mesh=mesh, refine_sweeps=2)
    assert r.neval > g.neval
    assert r.history[-1].direction == "mv"
    dg = -np.log10(g.errors[-1])
    dr = -np.log10(r.errors[-1])
    assert dr >= dg - 0.2, (dg, dr)
    assert r.ranks == g.ranks


def test_parallel_adaptive_gating():
    """cross_parallel(adaptive=True): each device gates its slab's bonds on
    their lottery residuals — fewer evaluations at identical digits on the
    rank-1-exact stdnorm, and identical ranks (gated bonds ship zero tapes,
    so every replica replays the same accepts)."""
    from ttcross_tpu.apps import make_stdnorm
    from ttcross_tpu.parallel.mesh import bond_mesh

    p = make_stdnorm(d=10, n=32)
    kw = dict(max_rank=8, accuracy=5 * 2.2e-16, pivoting=1,
              quad=[p.quad_weights] * p.d, truth=p.truth)
    mesh = bond_mesh(jax.devices()[:2])
    a = cross_parallel(p.fun, [p.n] * p.d, mesh=mesh, **kw)
    b = cross_parallel(p.fun, [p.n] * p.d, mesh=mesh, adaptive=True, **kw)
    assert b.neval < a.neval * 0.8, (b.neval, a.neval)
    assert b.errors[-1] == a.errors[-1]
    assert a.ranks == b.ranks


def test_pcontract_matches_host(rng):
    """Meshed TT contraction (parallel/quad.py::pcontract): real and
    complex weights on the 8-device mesh match the single-device path to
    rounding — the distributed ztt_quad (dmrgg.f90:1418-1523)."""
    import ttcross_tpu.tt as tt
    from ttcross_tpu.parallel import pcontract
    from ttcross_tpu.parallel.mesh import bond_mesh

    n, r = (4, 5, 3, 6, 4), (1, 3, 4, 2, 3, 1)
    cores = [rng.standard_normal((r[i], n[i], r[i + 1])) for i in range(5)]
    t = tt.from_cores(cores)
    mesh = bond_mesh(jax.devices()[:8])

    ws_r = [rng.standard_normal(ni) for ni in n]
    got = pcontract(t, ws_r, mesh)
    np.testing.assert_allclose(got, float(tt.contract(t, ws_r)), rtol=1e-12)

    ws_c = [w + 1j * rng.standard_normal(len(w)) for w in ws_r]
    got_c = pcontract(t, ws_c, mesh)
    np.testing.assert_allclose(got_c, complex(tt.contract(t, ws_c)),
                               rtol=1e-12)


def test_pcontract_chf_family(rng):
    """The chf driver's 32 Fourier contractions as ONE meshed collective:
    K-lane pcontract on the 8-device mesh matches basket_chf run on the
    single device (test_crs_chf.f90:153-168's 32 sequential ztt_quads)."""
    import ttcross_tpu.tt as tt
    from ttcross_tpu.apps import make_mvn
    from ttcross_tpu.apps.chf import basket_chf
    from ttcross_tpu.cross import cross
    from ttcross_tpu.parallel import pcontract
    from ttcross_tpu.parallel.mesh import bond_mesh

    prob = make_mvn(d=4, n=17)
    res = cross(prob.fun, [prob.n] * 4, max_rank=6,
                accuracy=500 * 2.2e-16, pivoting=1)
    want = basket_chf(res.tt, prob.nodes, prob.quad_weights, n_terms=32)

    omega = np.arange(32) * np.pi / 300.0
    phase = omega[:, None] * np.exp(prob.nodes)[None, :] / 4
    w_k = prob.quad_weights[None, :] * np.exp(1j * phase)   # (32, n)
    mesh = bond_mesh(jax.devices()[:8])
    got = pcontract(res.tt, [w_k] * 4, mesh)
    assert got.shape == (32,)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_parallel_runner_built_once_per_run_parameters(rng):
    """Repeated cross_parallel calls on one mesh reuse the jitted
    distributed run (a fresh jit per call retraced and recompiled every
    cross), and the reused run reproduces the first result."""
    from ttcross_tpu.config import precision_thresholds
    from ttcross_tpu.cross.engine import CrossConfig
    from ttcross_tpu.parallel.engine import get_parallel_engine
    from ttcross_tpu.parallel.mesh import bond_mesh

    cores = [rng.standard_normal((r0, 5, r1))
             for r0, r1 in zip((1, 2, 2, 2), (2, 2, 2, 1))]
    T = tt.from_cores(cores)

    def fun(ind):
        return tt.gather(T, ind)

    mesh = bond_mesh(jax.devices()[:2])
    se, sp = precision_thresholds()
    cfg = CrossConfig(d=4, n=(5,) * 4, N=5, R=3, piv=1, small_element=se,
                      small_pivot=sp)
    _, make_run_fn = get_parallel_engine(fun, cfg, mesh)
    assert make_run_fn(2, True, 1e-12) is make_run_fn(2, True, 1e-12)
    assert make_run_fn(2, True, 1e-12) is not make_run_fn(3, True, 1e-12)
    r1 = cross_parallel(fun, [5] * 4, max_rank=3, pivoting=1,
                        accuracy=1e-12, mesh=mesh)
    r2 = cross_parallel(fun, [5] * 4, max_rank=3, pivoting=1,
                        accuracy=1e-12, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(tt.full(r1.tt)),
                                  np.asarray(tt.full(r2.tt)))
