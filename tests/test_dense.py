import numpy as np
import pytest

from ttcross_tpu.ops.dense import (
    aca,
    eye,
    gram_schmidt,
    greedy_cur,
    laplace,
    matinv,
    norm2p,
    orto_block,
    qr_ort,
    svd_chopped,
    transpose3d,
)


def test_svd_chopped(rng):
    a = rng.standard_normal((10, 4)) @ rng.standard_normal((4, 8))
    u, s, vh, err = svd_chopped(a, tol=1e-12)
    assert len(s) == 4
    np.testing.assert_allclose((u * s) @ vh, a, atol=1e-10)


def test_matinv(rng):
    a = rng.standard_normal((6, 6))
    np.testing.assert_allclose(np.asarray(matinv(a)) @ a, np.eye(6), atol=1e-9)
    np.testing.assert_allclose(np.asarray(matinv(a, "lu")) @ a, np.eye(6), atol=1e-9)


def test_matinv_pseudo(rng):
    a = rng.standard_normal((6, 3)) @ rng.standard_normal((3, 6))  # rank 3
    pinv = np.asarray(matinv(a, tol=1e-10))
    np.testing.assert_allclose(a @ pinv @ a, a, atol=1e-9)


def test_eye_laplace():
    assert np.asarray(eye(3, 5)).shape == (3, 5)
    L = np.asarray(laplace(4))
    assert L[0, 0] == 2 and L[0, 1] == -1 and L[2, 3] == -1


def test_norm2p(rng):
    a = rng.standard_normal((12, 7))
    got = float(norm2p(a, iters=100))
    np.testing.assert_allclose(got, np.linalg.norm(a, 2), rtol=1e-6)


def test_qr_and_gram_schmidt(rng):
    a = rng.standard_normal((10, 4))
    q, r = qr_ort(a)
    np.testing.assert_allclose(np.asarray(q) @ np.asarray(r), a, atol=1e-10)
    v = rng.standard_normal(10)
    vo, c = gram_schmidt(q, v)
    np.testing.assert_allclose(np.asarray(q).T @ np.asarray(vo), 0, atol=1e-10)
    b = orto_block(q, rng.standard_normal((10, 3)))
    np.testing.assert_allclose(np.asarray(q).T @ np.asarray(b), 0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(b).T @ np.asarray(b), np.eye(3), atol=1e-9)


def test_aca_exact_rank(rng):
    a = rng.standard_normal((12, 3)) @ rng.standard_normal((3, 9))
    u, v, err = aca(a, tol=1e-13)
    assert u.shape[1] == 3
    np.testing.assert_allclose(u @ v, a, atol=1e-10)


def test_greedy_cur(rng):
    a = rng.standard_normal((8, 3)) @ rng.standard_normal((3, 8))
    u, v, rows, cols = greedy_cur(a, 3)
    np.testing.assert_allclose(u @ v, a, atol=1e-10)


def test_transpose3d(rng):
    a = rng.standard_normal((2, 3, 4))
    assert np.asarray(transpose3d(5, a)).shape == (3, 4, 2)
    np.testing.assert_array_equal(np.asarray(transpose3d(1, a)), a)


@pytest.mark.parametrize("case", ["table", "rows", "cols", "batched", "batched_1d"])
def test_lookups_match_numpy_indexing(rng, case):
    """The gather lookups agree with numpy indexing, and every index
    outside [0, n) (negative or past the end) reads 0."""
    import jax

    from ttcross_tpu.ops.dense import batched_row_lookup, row_lookup, table_lookup

    def ref(a, ind, axis=0):
        n = a.shape[axis]
        ok = (ind >= 0) & (ind < n)
        got = np.take(a, np.clip(ind, 0, n - 1), axis=axis)
        shape = [1] * got.ndim
        shape[axis] = ind.size
        return np.where(ok.reshape(shape) if got.ndim > 1 else ok, got, 0.0)

    if case == "table":
        tab = rng.standard_normal(17)
        ind = rng.integers(-3, 20, (64, 5))
        got = jax.jit(table_lookup)(tab, ind)
        want = np.where((ind >= 0) & (ind < 17), tab[np.clip(ind, 0, 16)], 0.0)
    elif case in ("rows", "cols"):
        axis = 0 if case == "rows" else 1
        mat = rng.standard_normal((12, 7) if axis == 0 else (7, 12))
        lin = rng.integers(-2, 14, 30)
        got = jax.jit(row_lookup, static_argnums=2)(mat, lin, axis)
        want = ref(mat, lin, axis)
        want = want if axis == 0 else want.T
    else:
        tabs = rng.standard_normal((3, 10, 4))
        lin = rng.integers(-1, 12, (3, 6) if case == "batched" else (3,))
        got = jax.jit(batched_row_lookup)(tabs, lin)
        want = np.stack([ref(tabs[b], np.atleast_1d(lin[b])) for b in range(3)])
        if case == "batched_1d":
            want = want[:, 0]
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.asarray(got), want)
