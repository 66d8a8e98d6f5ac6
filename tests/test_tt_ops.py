"""TT algebra unit tests against dense tensors (the unit layer the reference
lacks — SURVEY.md §4 implication)."""

import jax.numpy as jnp
import numpy as np
import pytest

import ttcross_tpu.tt as tt


def random_tt(rng, n=(4, 5, 3, 6), r=(1, 3, 4, 2, 1)):
    cores = [rng.standard_normal((r[i], n[i], r[i + 1])) for i in range(len(n))]
    return tt.from_cores(cores)


def test_ready_and_props(rng):
    t = random_tt(rng)
    assert t.ready()
    assert t.d == 4
    assert t.n == (4, 5, 3, 6)
    assert t.r == (1, 3, 4, 2, 1)
    assert t.mem() == 1 * 4 * 3 + 3 * 5 * 4 + 4 * 3 * 2 + 2 * 6 * 1


def test_full_vs_manual(rng):
    t = random_tt(rng, n=(3, 4), r=(1, 2, 1))
    dense = np.einsum("aib,bjc->ij", *[np.asarray(c) for c in t.cores])
    np.testing.assert_allclose(np.asarray(tt.full(t)), dense, rtol=1e-13)


def test_gather_matches_full(rng):
    t = random_tt(rng)
    dense = np.asarray(tt.full(t))
    ind = np.stack([rng.integers(0, ni, size=32) for ni in t.n], axis=1)
    vals = np.asarray(tt.gather(t, jnp.asarray(ind)))
    expect = dense[tuple(ind.T)]
    np.testing.assert_allclose(vals, expect, rtol=1e-12)


def test_gather_single_index(rng):
    t = random_tt(rng)
    dense = np.asarray(tt.full(t))
    v = tt.gather(t, jnp.array([1, 2, 0, 3]))
    np.testing.assert_allclose(float(v), dense[1, 2, 0, 3], rtol=1e-12)


def test_sumall_and_contract(rng):
    t = random_tt(rng)
    dense = np.asarray(tt.full(t))
    np.testing.assert_allclose(float(tt.sumall(t)), dense.sum(), rtol=1e-12)
    ws = [rng.standard_normal(ni) for ni in t.n]
    expect = np.einsum("ijkl,i,j,k,l->", dense, *ws)
    np.testing.assert_allclose(float(tt.contract(t, ws)), expect, rtol=1e-12)


def test_dot_and_norm(rng):
    a = random_tt(rng)
    b = random_tt(rng)
    da, db = np.asarray(tt.full(a)), np.asarray(tt.full(b))
    np.testing.assert_allclose(float(tt.dot(a, b)), (da * db).sum(), rtol=1e-12)
    np.testing.assert_allclose(float(tt.norm(a)), np.linalg.norm(da), rtol=1e-12)


def test_add_scale(rng):
    a = random_tt(rng)
    b = random_tt(rng, r=(1, 2, 3, 2, 1))
    expect = 2.5 * np.asarray(tt.full(a)) + np.asarray(tt.full(b))
    got = np.asarray(tt.full(tt.add(tt.scale(a, 2.5), b)))
    np.testing.assert_allclose(got, expect, rtol=1e-12)


def test_hadamard(rng):
    a = random_tt(rng)
    b = random_tt(rng, r=(1, 2, 2, 2, 1))
    expect = np.asarray(tt.full(a)) * np.asarray(tt.full(b))
    np.testing.assert_allclose(np.asarray(tt.full(tt.hadamard(a, b))), expect, rtol=1e-12)


def test_value_quantics(rng):
    # 1 coordinate expanded over 3 binary-ish modes
    t = random_tt(rng, n=(2, 2, 2), r=(1, 2, 2, 1))
    dense = np.asarray(tt.full(t))
    x = 0.625  # binary 0.101 -> indices (1, 0, 1)
    v = tt.value(t, jnp.array([x]))
    np.testing.assert_allclose(float(v), dense[1, 0, 1], rtol=1e-12)


def test_group_block_concat(rng):
    a = random_tt(rng)
    b = random_tt(rng, r=(1, 2, 3, 2, 1))
    g = tt.group(a, b, side=0)
    # side=0: shares right border; result is a stack whose border-0 slices select a and b
    assert g.r[-1] == 1 and g.r[0] == 2
    ga = tt.TT((g.cores[0][0:1],) + g.cores[1:])
    # selecting the first left-border slice reproduces a
    np.testing.assert_allclose(np.asarray(tt.full(ga)), np.asarray(tt.full(a)), rtol=1e-12)


def test_ones_zeros():
    o = tt.ones((3, 4, 5))
    assert float(tt.sumall(o)) == pytest.approx(60.0)
    z = tt.zeros((3, 4))
    assert float(tt.norm(z)) == 0.0


def test_erank():
    o = tt.ones((3, 3, 3, 3))
    assert o.erank() == pytest.approx(1.0)


def test_contract_complex_weights_device_pair(rng):
    """Real train x complex weights runs the DEVICE (re, im) pair path
    and matches the host complex128 chain to rounding (the ztt_quad
    equivalence, dmrgg.f90:1418-1523)."""
    t = random_tt(rng)
    ws = [rng.standard_normal(ni) + 1j * rng.standard_normal(ni)
          for ni in t.n]
    got = tt.contract(t, ws)
    # host complex reference chain
    v = np.ones((1,), dtype=np.complex128)
    for c in range(t.d):
        v = v @ np.einsum("inj,n->ij", np.asarray(t.cores[c]), ws[c])
    assert isinstance(got, complex)
    np.testing.assert_allclose(got, v[0], rtol=1e-13)


def test_contract_complex_cores_host(rng):
    """Complex-cored trains keep the host path."""
    cores = [rng.standard_normal((r, n, r2)) + 1j * rng.standard_normal((r, n, r2))
             for (r, n, r2) in [(1, 3, 2), (2, 4, 1)]]
    t = tt.from_cores([np.asarray(c) for c in cores])
    ws = [np.ones(3), np.ones(4)]
    got = tt.contract(t, ws)
    v = np.ones((1,), dtype=np.complex128)
    for c in range(2):
        v = v @ np.einsum("inj,n->ij", cores[c], ws[c])
    np.testing.assert_allclose(got, v[0], rtol=1e-13)
