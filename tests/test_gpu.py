"""On-card checks.  They skip where JAX has no GPU (the gpu_device fixture
decides at run time); on the card run them with
`TTCROSS_TEST_GPU=1 python -m pytest tests/ -m gpu`, and the full set of
on-card checks with `python chip_smoke.py`."""

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_lookups_on_gpu_match_numpy(rng, gpu_device):
    from ttcross_tpu.ops.dense import batched_row_lookup, table_lookup

    tab = rng.standard_normal(17)
    ind = rng.integers(-2, 19, (4096, 255))
    with jax.default_device(gpu_device):
        got = np.asarray(jax.jit(table_lookup)(tab, ind))
    ok = (ind >= 0) & (ind < 17)
    np.testing.assert_array_equal(got, np.where(ok, tab[np.clip(ind, 0, 16)], 0.0))
    tabs = rng.standard_normal((254, 170, 10))
    lin = rng.integers(0, 170, (254, 54))
    with jax.default_device(gpu_device):
        got = np.asarray(jax.jit(batched_row_lookup)(tabs, lin))
    np.testing.assert_array_equal(got, np.take_along_axis(tabs, lin[..., None], 1))


def test_c6_greedy_on_gpu(gpu_device):
    from ttcross_tpu.apps import make_ising
    from ttcross_tpu.cross import cross

    p = make_ising("C", m=6, n=64)
    with jax.default_device(gpu_device):
        res = cross(p.fun, [p.n] * p.d, max_rank=24, accuracy=500 * 2.2e-16,
                    pivoting=1, quad=[p.quad_weights] * p.d, truth=p.truth)
    assert -np.log10(res.errors[-1]) >= 11.5
