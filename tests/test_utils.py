"""Utility-layer tests: multi-index arithmetic (ttind.f90 parity), printers,
and numerical guards."""

import numpy as np
import pytest

import ttcross_tpu.tt as tt
from ttcross_tpu.utils import (
    has_nan,
    lex_compare,
    lex_find,
    lex_push,
    lex_sort,
    lin_to_multi,
    multi_to_lin,
    say,
    say_tt,
    saynnz,
    tt_check,
)


def test_lin_multi_roundtrip(rng):
    n = (3, 4, 5)
    lin = rng.integers(0, 60, size=16)
    ind = np.asarray(lin_to_multi(lin, n))
    back = np.asarray(multi_to_lin(ind, n))
    np.testing.assert_array_equal(back, lin)
    # first mode fastest (Fortran column-major convention, ttind.f90:91-105)
    np.testing.assert_array_equal(np.asarray(lin_to_multi(np.array([1]), n))[0], [1, 0, 0])
    np.testing.assert_array_equal(np.asarray(lin_to_multi(np.array([3]), n))[0], [0, 1, 0])


def test_lex_machinery():
    a, b = np.array([1, 2, 3]), np.array([2, 2, 3])
    assert lex_compare(a, b) == -1
    assert lex_compare(b, a) == 1
    assert lex_compare(a, a) == 0
    # last mode most significant
    assert lex_compare(np.array([9, 0, 0]), np.array([0, 0, 1])) == -1

    inds = lex_sort(np.array([[2, 1], [0, 0], [1, 1], [3, 0]]))
    assert lex_find(inds, np.array([1, 1])) >= 0
    assert lex_find(inds, np.array([9, 9])) == -1
    out = lex_push(inds, np.array([5, 5]))
    assert len(out) == len(inds) + 1
    out2 = lex_push(out, np.array([5, 5]))  # duplicate dropped
    assert len(out2) == len(out)


def test_guards(rng):
    good = tt.ones((3, 3))
    tt_check(good)  # no raise
    assert not has_nan(np.ones(3))
    assert has_nan(np.array([1.0, np.nan]))
    bad = tt.TT((np.ones((1, 3, 2)), np.full((2, 3, 1), np.nan)))
    with pytest.raises(FloatingPointError):
        tt_check(bad)
    inconsistent = tt.TT((np.ones((1, 3, 2)), np.ones((3, 3, 1))))
    with pytest.raises(ValueError):
        tt_check(inconsistent)


def test_printers_smoke(rng, capsys):
    say(rng.standard_normal((3, 4)))
    say(rng.standard_normal(5))
    say(rng.standard_normal((2, 2, 2)))
    say(np.array([[1 + 2j, 3 - 4j]]))
    say(np.array([[1, 2], [3, 4]]))
    saynnz(np.array([0.0, 2.0, 0.0, -3.0]), tol=1.0)
    say_tt(tt.ones((3, 4)))
    out = capsys.readouterr().out
    assert "erank" in out and "(1,)" in out


def test_print_config_no_backend_init():
    """print_config must NEVER be the first device touch: it reports the
    backend only if already initialized (a jax.devices() call in the
    banner would open the accelerator, and reserve its memory, even for
    host-only drivers like the mpmath tier)."""
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from ttcross_tpu.utils import print_config\n"
        "from jax._src import xla_bridge as xb\n"
        "print_config(alpha=1, beta='x')\n"
        "assert not xb._backends, 'banner initialized a jax backend'\n"
        "print('BANNER_OK')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=str(__import__("pathlib").Path(__file__).parent.parent))
    assert out.returncode == 0, out.stderr
    assert "BANNER_OK" in out.stdout
    assert "not initialized" in out.stdout
