#!/usr/bin/env python
"""Cross-language CHF check: JAX gaussian_chf vs the independent C++
long-double implementation over a parameter grid (test_chf_equal.f90:44-63
parity; the reference compared against an external binary it didn't vendor —
ours lives in ttcross_tpu/native)."""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

import ttcross_tpu  # noqa: F401
from ttcross_tpu import native
from ttcross_tpu.apps.cos import gaussian_chf_parts
from ttcross_tpu.utils import readarg


def main():
    d = readarg(1, 4)
    g = readarg(2, 3)

    if not native.available():
        print("native toolchain unavailable; nothing to compare")
        return 1

    rng = np.random.default_rng(0)
    mu = rng.standard_normal(d)
    A = rng.standard_normal((d, d))
    sigma = A @ A.T / d
    grids = np.meshgrid(*[np.linspace(-1.0, 1.0, g)] * d, indexing="ij")
    omega = np.stack([x.ravel() for x in grids], axis=1)

    re, im = gaussian_chf_parts(omega, mu, sigma)  # real-pair math
    ours = np.asarray(re) + 1j * np.asarray(im)
    cpp = native.gaussian_chf_native(omega, mu, sigma)
    err = np.abs(ours - cpp).max()
    print(f"compared {len(omega)} CHF values: max |jax - c++| = {err:.3e}")
    print("EQUAL" if err < 1e-13 else "MISMATCH")
    return 0 if err < 1e-13 else 2


if __name__ == "__main__":
    sys.exit(main())
