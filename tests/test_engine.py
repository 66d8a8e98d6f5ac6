"""Cross-engine tests: exact-rank recovery, pivoting modes, and
correct-digits parity with the reference drivers (SURVEY.md §4, §7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ttcross_tpu.tt as tt
from ttcross_tpu.apps import make_ising, make_stdnorm
from ttcross_tpu.cross import cross
from ttcross_tpu.cross.accchk import accchk


def make_low_rank(rng, d, n, ranks):
    cores = [rng.standard_normal((ranks[i], n, ranks[i + 1])) for i in range(d)]
    T = tt.from_cores(cores)
    dense = np.asarray(tt.full(T))

    def fun(ind):
        return tt.gather(T, ind)

    return T, dense, fun


@pytest.mark.parametrize("pivoting", [1, 0, -1, 2])
def test_exact_rank_recovery(rng, pivoting):
    _, dense, fun = make_low_rank(rng, 3, 7, (1, 2, 2, 1))
    res = cross(fun, [7] * 3, max_rank=4, pivoting=pivoting, accuracy=1e-12)
    approx = np.asarray(tt.full(res.tt))
    assert np.abs(approx - dense).max() < 1e-12
    assert res.ranks == (1, 2, 2, 1)


def test_exact_rank_recovery_d5(rng):
    _, dense, fun = make_low_rank(rng, 5, 6, (1, 2, 3, 3, 2, 1))
    res = cross(fun, [6] * 5, max_rank=5, pivoting=1, accuracy=1e-12)
    approx = np.asarray(tt.full(res.tt))
    assert np.abs(approx - dense).max() < 1e-11


def test_stdnorm_digits():
    """Rank-1 product Gaussian: engine must stay rank 1 and the quadrature
    value must match pi^(d/2) (test_crs_stdnorm parity)."""
    prob = make_stdnorm(d=6, n=65)
    res = cross(prob.fun, [prob.n] * 6, max_rank=6, accuracy=25e-16,
                pivoting=1, quad=[prob.quad_weights] * 6, truth=prob.truth)
    digits = -np.log10(res.errors[-1])
    assert digits >= 12, (res.errors[-1], digits)
    assert max(res.ranks) == 1  # separable integrand stays rank-1
    assert res.converged


def test_ising_c4_digits():
    """Ising C_4 (d=3) to >= 9 digits by rank 16 (test_crs_ising parity)."""
    prob = make_ising("C", m=4, n=65)
    res = cross(prob.fun, [prob.n] * prob.d, max_rank=16, accuracy=500 * 2.2e-16,
                pivoting=1, quad=[prob.quad_weights] * prob.d, truth=prob.truth)
    digits = -np.log10(res.errors[-1])
    assert digits >= 9, (res.errors[-1], digits)


def test_accchk_interpolation(rng):
    """The finalized TT must interpolate the black box well everywhere
    (dtt_accchk parity)."""
    _, dense, fun = make_low_rank(rng, 4, 6, (1, 2, 2, 2, 1))
    res = cross(fun, [6] * 4, max_rank=4, pivoting=1, accuracy=1e-12)
    chk = accchk(res.tt, fun, nlot=4096)
    assert chk["einf"] <= 1e-11 * max(1.0, chk["ainf"])


def test_quad_values_match_final_contract(rng):
    """Per-sweep quadrature value must equal contracting the finalized TT."""
    _, dense, fun = make_low_rank(rng, 3, 7, (1, 2, 2, 1))
    w = [rng.standard_normal(7) for _ in range(3)]
    res = cross(fun, [7] * 3, max_rank=4, pivoting=1, accuracy=1e-12, quad=w)
    final = float(tt.contract(res.tt, w))
    assert abs(res.values[-1] - final) < 1e-10 * max(1.0, abs(final))


def test_ragged_modes(rng):
    """Per-mode sizes may differ (padding machinery)."""
    ns = (5, 8, 6)
    cores = [rng.standard_normal((r1, n, r2)) for (r1, r2), n in
             zip([(1, 2), (2, 2), (2, 1)], ns)]
    T = tt.from_cores(cores)
    dense = np.asarray(tt.full(T))

    def fun(ind):
        return tt.gather(T, ind)

    res = cross(fun, ns, max_rank=4, pivoting=1, accuracy=1e-12)
    assert res.tt.n == ns
    approx = np.asarray(tt.full(res.tt))
    assert np.abs(approx - dense).max() < 1e-11


def test_neval_counts_are_active_only(rng):
    _, dense, fun = make_low_rank(rng, 3, 7, (1, 2, 2, 1))
    res = cross(fun, [7] * 3, max_rank=3, pivoting=1)
    assert res.neval < 7**3  # far fewer evals than the full tensor


def test_checkpoint_resume(rng, tmp_path):
    """Engine-state checkpoint/resume: stopping after k sweeps and resuming
    must land at the same accuracy as an uninterrupted run."""
    from ttcross_tpu.tt.serialize import load_state, save_state

    _, dense, fun = make_low_rank(rng, 3, 7, (1, 2, 2, 1))
    r1 = cross(fun, [7] * 3, max_rank=4, max_sweeps=1, pivoting=1, return_state=True)
    p = str(tmp_path / "ck.npz")
    save_state(r1.state, p)
    st = load_state(p)
    r2 = cross(fun, [7] * 3, max_rank=4, pivoting=1, accuracy=1e-12, init_state=st)
    approx = np.asarray(tt.full(r2.tt))
    assert np.abs(approx - dense).max() < 1e-11


def test_chunked_rank_growth(rng):
    """rank_chunks: chunked padding growth must recover the tensor exactly
    like the single-chunk run while doing strictly fewer padded (actual)
    integrand evaluations; counted n_evals stays reference-equivalent."""
    _, dense, fun = make_low_rank(rng, 4, 9, (1, 3, 4, 3, 1))
    single = cross(fun, [9] * 4, max_rank=8, pivoting=1, accuracy=1e-12)
    chunked = cross(fun, [9] * 4, max_rank=8, pivoting=1, accuracy=1e-12,
                    rank_chunks=[4, 8])
    approx = np.asarray(tt.full(chunked.tt))
    assert np.abs(approx - dense).max() < 1e-10
    assert chunked.padded_evals < single.padded_evals
    assert chunked.padded_evals < 2.2 * chunked.neval


def test_chunked_matches_auto_schedule(rng):
    _, dense, fun = make_low_rank(rng, 3, 8, (1, 2, 2, 1))
    res = cross(fun, [8] * 3, max_rank=12, pivoting=1, accuracy=1e-12,
                rank_chunks="auto")
    approx = np.asarray(tt.full(res.tt))
    assert np.abs(approx - dense).max() < 1e-11


def test_pad_state_preserves_semantics(rng):
    """pad_state embedding: a state padded mid-run must finalize to the
    same TT values (the maintained inverses keep their block structure)."""
    from ttcross_tpu.cross.engine import CrossConfig, finalize, get_engine
    from ttcross_tpu.cross.state import pad_state

    T, dense, fun = make_low_rank(rng, 3, 7, (1, 2, 2, 1))
    r1 = cross(fun, [7] * 3, max_rank=4, pivoting=1, accuracy=1e-12,
               return_state=True)
    st8 = pad_state(r1.state, 8)
    cfg8 = CrossConfig(d=3, n=(7, 7, 7), N=7, R=8, piv=1,
                       small_element=1e-14, small_pivot=1e-7)
    tt8 = finalize(st8, cfg8)
    approx = np.asarray(tt.full(tt8))
    assert np.abs(approx - dense).max() < 1e-11


def test_weighted_lottery(rng):
    """lottery2's arbitrary-weights path (rnd.f90:105-126): quadrature-
    weighted candidate draws still recover the tensor exactly."""
    from ttcross_tpu.apps import make_mvn

    prob = make_mvn(d=4, n=33)
    res = cross(prob.fun, [prob.n] * 4, max_rank=10, pivoting=1,
                accuracy=500 * 2.2e-16, quad=[prob.quad_weights] * 4,
                truth=1.0, weighted_lottery=True)
    assert -np.log10(res.errors[-1]) > 3
    with pytest.raises(ValueError):
        cross(prob.fun, [prob.n] * 4, max_rank=4, weighted_lottery=True)


def test_weighted_lottery_with_rank_caps():
    """The capped sweep honours weighted_lottery (its lottery previously
    dropped the weights silently): the weighted capped run still recovers
    the integral, and differs from the unweighted capped run's draw path
    (same key, different candidate distribution)."""
    from ttcross_tpu.apps import make_mvn

    prob = make_mvn(d=4, n=33)
    args = dict(max_rank=10, pivoting=1, accuracy=500 * 2.2e-16,
                quad=[prob.quad_weights] * 4, truth=1.0,
                rank_caps=[8, 10, 8], key=3)
    res_w = cross(prob.fun, [prob.n] * 4, weighted_lottery=True, **args)
    assert -np.log10(res_w.errors[-1]) > 3
    res_u = cross(prob.fun, [prob.n] * 4, **args)
    assert res_w.neval != res_u.neval or res_w.values[-1] != res_u.values[-1]


def test_oversample_beats_greedy_ceiling():
    """cross(oversample=k): cross-and-round reaches past the greedy-append
    quality ceiling at fixed rank (MVN d=4 case; the d=6 numbers are in
    BENCH_NOTES 'Pivot-quality ceiling')."""
    from ttcross_tpu.apps import make_mvn

    prob = make_mvn(d=4, n=33)
    w = [prob.quad_weights] * 4
    plain = cross(prob.fun, [prob.n] * 4, max_rank=8, pivoting=1,
                  accuracy=500 * 2.2e-16, quad=w, truth=1.0)
    over = cross(prob.fun, [prob.n] * 4, max_rank=8, pivoting=1,
                 accuracy=500 * 2.2e-16, quad=w, truth=1.0, oversample=4)
    assert max(over.ranks) <= 8
    assert over.errors[-1] < plain.errors[-1]


@pytest.mark.parametrize("kind,digits_min", [("D", 12),
                         pytest.param("E", 10.5, marks=pytest.mark.slow)])
def test_ising_de_cross(kind, digits_min):
    """D_4 / E_4 through the full cross (the reference's D/E families,
    test_crs_ising.f90; previously only dense-contraction tested)."""
    prob = make_ising(kind, m=4, n=33)
    res = cross(prob.fun, [prob.n] * prob.d, max_rank=16,
                accuracy=500 * 2.2e-16, pivoting=1,
                quad=[prob.quad_weights] * prob.d, truth=prob.truth)
    assert -np.log10(res.errors[-1]) >= digits_min


@pytest.mark.parametrize("pivoting", [1, 0])
def test_jacobi_exact_rank_recovery(rng, pivoting):
    """sweep_mode='jacobi': all-bonds-batched sweeps recover exact-rank
    tensors like the sequential engine (the staleness license of the
    reference's own parallel decomposition, dmrgg.f90:822-850)."""
    _, dense, fun = make_low_rank(rng, 4, 7, (1, 2, 3, 2, 1))
    res = cross(fun, [7] * 4, max_rank=5, pivoting=pivoting, accuracy=1e-12,
                sweep_mode="jacobi")
    approx = np.asarray(tt.full(res.tt))
    assert np.abs(approx - dense).max() < 1e-10 * np.abs(dense).max()


def test_jacobi_ising_envelope():
    """C_4: jacobi sweeps land in the sequential accuracy envelope at the
    same rank budget (corner-fiber repairs keep factors exact)."""
    prob = make_ising("C", m=4, n=65)
    args = dict(max_rank=16, accuracy=500 * 2.2e-16, pivoting=1,
                quad=[prob.quad_weights] * prob.d, truth=prob.truth)
    seq = cross(prob.fun, [prob.n] * prob.d, **args)
    jac = cross(prob.fun, [prob.n] * prob.d, sweep_mode="jacobi", **args)
    # floor at f64 resolution: a perfect value (rel err rounds to exactly
    # 0.0, observed with the pairwise-tree value_fn) would give inf digits
    ds = -np.log10(max(float(seq.errors[-1]), 1e-16))
    dj = -np.log10(max(float(jac.errors[-1]), 1e-16))
    assert dj >= 8.0, (ds, dj)
    assert abs(dj - ds) < 3.5, (ds, dj)   # same envelope, stochastic pivots


def test_jacobi_counts_padded_evals():
    prob = make_ising("C", m=4, n=33)
    res = cross(prob.fun, [prob.n] * prob.d, max_rank=8, pivoting=1,
                sweep_mode="jacobi",
                quad=[prob.quad_weights] * prob.d, truth=prob.truth)
    assert res.padded_evals > res.neval > 0


def test_jacobi_rejects_full_pivoting():
    prob = make_ising("C", m=4, n=17)
    with pytest.raises(ValueError, match="jacobi"):
        cross(prob.fun, [prob.n] * prob.d, max_rank=4, pivoting=-1,
              sweep_mode="jacobi")


@pytest.mark.slow
def test_rank_caps_padded_ratio():
    """Per-bond rank caps + chunked growth close the padded-work gap:
    counted padded_ratio <= 1.25 on the C_6 bench config (VERDICT #4;
    the reference's dynamic shapes are ratio 1.0)."""
    prob = make_ising("C", m=6, n=64)
    args = dict(max_rank=24, accuracy=500 * 2.2e-16, pivoting=1,
                quad=[prob.quad_weights] * prob.d, truth=prob.truth)
    res = cross(prob.fun, [prob.n] * prob.d,
                rank_chunks=[4, 8, 12, 16, 20, 24],
                rank_caps=[16, 24, 24, 16], **args)
    ratio = res.padded_evals / res.neval
    assert ratio <= 1.25, ratio
    assert -np.log10(res.errors[-1]) >= 11.0


def test_rank_caps_small_recovery(rng):
    """Capped visits recover an exact-rank tensor (capped batches embed
    into the full-R machinery losslessly)."""
    _, dense, fun = make_low_rank(rng, 4, 7, (1, 2, 3, 2, 1))
    res = cross(fun, [7] * 4, max_rank=5, pivoting=1, accuracy=1e-12,
                rank_caps=[3, 4, 3])
    approx = np.asarray(tt.full(res.tt))
    assert np.abs(approx - dense).max() < 1e-10 * np.abs(dense).max()


def test_rank_caps_validation():
    prob = make_ising("C", m=4, n=17)
    with pytest.raises(ValueError, match="rank_caps"):
        cross(prob.fun, [prob.n] * prob.d, max_rank=4, rank_caps=[2])
    with pytest.raises(ValueError, match="jacobi"):
        cross(prob.fun, [prob.n] * prob.d, max_rank=4, rank_caps=[2, 2],
              sweep_mode="jacobi")


def test_adaptive_gating_skips_converged_bonds():
    """Adaptive hunt gating (cross(adaptive=True)): on the rank-1-exact
    stdnorm integrand every post-convergence bond visit skips its rook
    fibers, cutting n_evals below the reference's every-bond-every-sweep
    count at IDENTICAL accuracy."""
    from ttcross_tpu.apps import make_stdnorm

    p = make_stdnorm(d=10, n=32)
    kw = dict(max_rank=8, accuracy=5 * 2.2e-16, pivoting=1,
              quad=[p.quad_weights] * p.d, truth=p.truth)
    greedy = cross(p.fun, [p.n] * p.d, **kw)
    gated = cross(p.fun, [p.n] * p.d, adaptive=True, **kw)
    assert gated.neval < greedy.neval * 0.8, (gated.neval, greedy.neval)
    assert gated.errors[-1] == greedy.errors[-1]
    assert gated.ranks == greedy.ranks


def test_adaptive_gating_never_changes_the_train(rng):
    """The gate may skip post-saturation visits (fewer evals) but must
    never alter the accepted pivots: the returned train is bit-identical
    to the plain greedy run's."""
    _, dense, fun = make_low_rank(rng, 4, 9, (1, 3, 3, 3, 1))
    kw = dict(max_rank=5, pivoting=1, accuracy=1e-12)
    a = cross(fun, [9] * 4, **kw)
    b = cross(fun, [9] * 4, adaptive=True, **kw)
    assert b.neval <= a.neval
    assert a.ranks == b.ranks
    np.testing.assert_array_equal(np.asarray(tt.full(a.tt)),
                                  np.asarray(tt.full(b.tt)))


def test_adaptive_validation():
    prob = make_ising("C", m=4, n=17)
    with pytest.raises(ValueError, match="adaptive"):
        cross(prob.fun, [prob.n] * prob.d, max_rank=4, adaptive=True,
              pivoting=-1)
    with pytest.raises(ValueError, match="adaptive"):
        cross(prob.fun, [prob.n] * prob.d, max_rank=4, adaptive=True,
              sweep_mode="jacobi")
    with pytest.raises(ValueError, match="adaptive"):
        cross(prob.fun, [prob.n] * prob.d, max_rank=4, adaptive=True,
              rank_caps=[2, 2])


def test_oversample_respects_rank_caps():
    """oversample must not silently drop rank_caps: the inflated run gets
    caps+oversample headroom per bond and the rounding pass truncates back
    to max_rank (previously the caps were dropped on the recursion)."""
    prob = make_ising("C", m=4, n=17)
    quad = [prob.quad_weights] * prob.d
    r = cross(prob.fun, [prob.n] * prob.d, max_rank=6, pivoting=1,
              oversample=2, rank_caps=[4, 6], quad=quad, truth=prob.truth)
    assert max(r.ranks) <= 6
    # the inflated run was capped at (6, 8): bond 0 cannot exceed 6
    assert r.ranks[1] <= 6
    assert r.errors[-1] < 1e-6


def test_ising_de_rescaling_d10():
    """The D/E underflow-rescaling regime at d >= 10 end-to-end
    (test_crs_ising.f90:135-144: weights scaled by 5*(n//2) per dim, the
    rank-1 quad tensor compensating by 1/val).  No tabulated truth exists
    for m=10, so the assertions are the mechanics the rescale protects:
    integrand values stay inside the floating range (no flush-to-zero,
    no overflow), the cross converges (cnv), and an oversampled run
    reproduces the value (self-consistency)."""
    for kind in ("D", "E"):
        prob = make_ising(kind, m=10, n=17)
        assert prob.rescale, "m >= 10 D/E must take the rescaled path"
        # the rescale keeps sampled integrand values normal-range
        rng = np.random.default_rng(7)
        ind = rng.integers(0, prob.n, size=(512, prob.d)).astype(np.int32)
        vals = np.asarray(prob.fun(ind))
        assert np.all(np.isfinite(vals))
        amax = np.max(np.abs(vals))
        assert 1e-300 < amax < 1e300
        assert np.count_nonzero(vals) > 0.9 * len(vals)

        args = dict(max_rank=8, accuracy=500 * 2.2e-16, pivoting=1,
                    quad=[prob.quad_weights] * prob.d)
        res = cross(prob.fun, [prob.n] * prob.d, **args)
        v1 = res.values[-1]
        assert np.isfinite(v1) and v1 != 0.0
        assert res.errors[-1] < 1e-5          # cnv: converging, not stuck
        res2 = cross(prob.fun, [prob.n] * prob.d, oversample=4, **args)
        # self-consistency: a rescaling bug is orders-of-magnitude off
        assert abs(1.0 - res2.values[-1] / v1) < 1e-4


@pytest.mark.parametrize("p", [0, 1, 2])
def test_full_pivot_matches_bruteforce_argmax(rng, p):
    """pivoting=-1 picks the superblock entry of largest residual
    |A - colf[p] rowf[p+1]| over the active block, as a numpy brute
    force over every (i, j, k, q) does (dmrgg.f90:341-408)."""
    from ttcross_tpu.config import precision_thresholds
    from ttcross_tpu.cross import make_engine
    from ttcross_tpu.cross.chains import pivot_index_sets
    from ttcross_tpu.cross.engine import CrossConfig

    d, n, R = 4, 5, 5
    _, dense, fun = make_low_rank(rng, d, n, (1, 4, 4, 4, 1))
    st = cross(fun, [n] * d, max_rank=R, pivoting=-1, max_sweeps=1,
               return_state=True).state
    se, sp = precision_thresholds()
    kit = make_engine(fun, CrossConfig(d=d, n=(n,) * d, N=n, R=R, piv=-1,
                                       small_element=se, small_pivot=sp))
    _, tape_i, tape_f = jax.jit(lambda s: kit.visit_bond(s, p, True))(st)

    rk = np.asarray(st.rk)
    I, J = pivot_index_sets(st.vip, st.rk)
    lefts = I[p - 1] if p > 0 else [()]
    rights = J[p + 1] if p + 1 < d - 1 else [()]
    colf = np.asarray(st.colf[p])[..., : rk[p + 1]]
    rowf = np.asarray(st.rowf[p + 1])[: rk[p + 1]]
    best, arg = -1.0, None
    for i, left in enumerate(lefts[: rk[p]]):
        for q, right in enumerate(rights[: rk[p + 2]]):
            for j in range(n):
                for k in range(n):
                    r = dense[left + (j, k) + right] - colf[i, j] @ rowf[:, k, q]
                    if abs(r) > best:
                        best, arg, resid = abs(r), (i, j, k, q), r
    assert int(tape_i[0]) == 1, "the pivot must be accepted"
    assert tuple(int(x) for x in tape_i[1:]) == arg
    np.testing.assert_allclose(float(tape_f[-1]), resid, rtol=1e-10)
