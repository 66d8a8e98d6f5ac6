"""Defect-corrected high-precision cross (cross/defect.py): the device-first
replacement for running the greedy engine in arbitrary precision."""

from decimal import Decimal, getcontext

import numpy as np
import pytest

import ttcross_tpu  # noqa: F401
from ttcross_tpu import native
from ttcross_tpu.apps.ising import make_ising_dd
from ttcross_tpu.apps.truths import ISING_C_STR
from ttcross_tpu.cross.defect import cross_defect_corrected

pytestmark = pytest.mark.skipif(not native.available(), reason="no native toolchain")


def _digits(hi, lo, tru_str):
    getcontext().prec = 60
    rel = abs(1 - (Decimal(hi) + Decimal(lo)) / Decimal(tru_str))
    return float(-rel.log10()) if rel != 0 else 60.0


def test_dd_integrand_matches_native(rng):
    """Device dd Ising integrand == host __float128 integrand to ~1e-30."""
    prob, fun_dd, wh, wl = make_ising_dd(m=6, n=17)
    ind = rng.integers(0, prob.n, size=(16, prob.d))
    dev = fun_dd(ind)
    import jax.numpy as jnp

    from ttcross_tpu.ops.dd import DD, dd, dd_add, dd_mul

    (xh, xl), (gwh, gwl) = native.gauss_legendre_dd(17)
    half = dd(0.5)
    Xn = dd_mul(dd_add(DD(jnp.asarray(xh), jnp.asarray(xl)), dd(1.0)), half)
    Wn = dd_mul(DD(jnp.asarray(gwh), jnp.asarray(gwl)), dd(0.5 * (17 // 2)))
    hh, ll = native.ising_c_dd(ind, np.asarray(Xn.hi), np.asarray(Xn.lo),
                               np.asarray(Wn.hi), np.asarray(Wn.lo))
    err = np.abs((np.asarray(dev.hi) - hh) + (np.asarray(dev.lo) - ll))
    assert err.max() < 1e-28 * max(1.0, np.abs(hh).max())


@pytest.mark.slow
def test_defect_corrected_c4():
    """Ising C_4 defect-corrected: beats the plain f64 pipeline."""
    prob, fun_dd, wh, wl = make_ising_dd(m=4, n=33)
    hi, lo, info = cross_defect_corrected(prob.fun, fun_dd, [prob.n] * prob.d,
                                          wh, wl, max_rank=16, max_rank2=24)
    digits = _digits(hi, lo, ISING_C_STR[4])
    assert digits >= 13, digits


@pytest.mark.slow
def test_defect_corrected_c6_beyond_f64():
    """Ising C_6 at ranks (32, 48): >= 15.5 correct digits — past what any
    pure-f64 pipeline can represent (measured 16.0)."""
    prob, fun_dd, wh, wl = make_ising_dd(m=6, n=65)
    hi, lo, info = cross_defect_corrected(prob.fun, fun_dd, [prob.n] * prob.d,
                                          wh, wl, max_rank=32, max_rank2=48)
    digits = _digits(hi, lo, ISING_C_STR[6])
    assert digits >= 15.5, digits


@pytest.mark.slow
def test_defect_corrected_on_mesh():
    """Parallel defect correction: both crosses run on a 2-device bond mesh
    and reach beyond-f64 accuracy (the distributed analogue of the
    reference's MPI mp tier)."""
    import jax

    from ttcross_tpu.parallel.mesh import bond_mesh

    prob, fun_dd, wh, wl = make_ising_dd(m=4, n=33)
    hi, lo, info = cross_defect_corrected(
        prob.fun, fun_dd, [prob.n] * prob.d, wh, wl,
        max_rank=16, accuracy=500 * 2.2e-16, pivoting=1,
        mesh=bond_mesh(jax.devices()[:2]))
    digits = _digits(hi, lo, ISING_C_STR[4])
    assert digits >= 16, digits


def test_qd_integrand_matches_mp(rng):
    """qd Ising integrand == mpmath integrand to ~1e-55 (the noise floor
    that makes the third defect level pay off)."""
    from mpmath import workdps

    from ttcross_tpu.apps.ising import make_ising_mp, make_ising_qd
    from ttcross_tpu.ops.qd import qd_to_mp

    prob, fun_qd, wq = make_ising_qd(m=4, n=17)
    _, _, fun_mp, _, _ = make_ising_mp("C", m=4, n=17, dps=80)
    ind = rng.integers(0, prob.n, size=(12, prob.d))
    got = fun_qd(ind)
    want = fun_mp(ind)
    with workdps(80):
        for b in range(12):
            g = qd_to_mp(float(np.asarray(got.e0)[b]),
                         float(np.asarray(got.e1)[b]),
                         float(np.asarray(got.e2)[b]),
                         float(np.asarray(got.e3)[b]))
            rel = abs(1 - g / want[b])
            assert float(rel) < 1e-55, (b, float(rel))


@pytest.mark.slow
def test_defect_corrected_qd_c4_beyond_dd():
    """Ising C_4 THREE-level qd defect correction at FULL second-level
    rank: >= 31 correct digits — past the dd ENGINE's ~31-digit
    evaluation floor, with every cross still in the plain f64 engine.

    The defect of an f64 train is noise-like (the cores' f64 rounding is
    effectively full-rank), so the correction levels only bite at
    (near-)full rank: for C_4 (d=3, n=33) max_rank2=33 IS full rank and
    measures 33.7 digits, while max_rank2=30 — only three ranks short —
    collapses to 22.0.  The n=17 rule caps at ~17.8 digits, so n=33 is
    the smallest standard config for this test (rule error at n=33
    supports >= 50, test_engine_mp)."""
    from mpmath import mp, mpf, workdps

    from ttcross_tpu.apps.ising import make_ising_qd
    from ttcross_tpu.cross.defect import cross_defect_corrected_qd
    from ttcross_tpu.ops.qd import qd_to_mp

    prob, fun_qd, wq = make_ising_qd(m=4, n=33)
    limbs, info = cross_defect_corrected_qd(
        prob.fun, fun_qd, [prob.n] * prob.d, wq,
        max_rank=16, max_rank2=33, levels=3)
    with workdps(75):
        rel = abs(1 - qd_to_mp(*limbs) / mpf(ISING_C_STR[4]))
        digits = float(-mp.log10(rel)) if rel != 0 else 75.0
    assert digits >= 31, (digits, info["ranks"])
