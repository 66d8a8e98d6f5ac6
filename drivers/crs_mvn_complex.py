#!/usr/bin/env python
"""MVN probability through the COMPLEX contraction path:
`crs_mvn_complex.py D N RANK PIV` (test_crs_mvn_complex.f90 parity —
validates the complex pipeline with unit imaginary weights)."""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

import ttcross_tpu  # noqa: F401
import ttcross_tpu.tt as tt
from ttcross_tpu.apps import make_mvn
from ttcross_tpu.cross import cross
from ttcross_tpu.utils import print_config, readarg
from ttcross_tpu.utils.cli import maybe_accchk


def main():
    d = readarg(1, 6)
    n = readarg(2, 65)
    rank = readarg(3, 20)
    piv = readarg(4, 1)

    prob = make_mvn(d=d, n=n)
    print_config(dimension=d, quadratur=prob.n, TT_ranks=rank, pivoting=piv)
    acc = 500 * np.finfo(np.float64).eps
    res = cross(prob.fun, [prob.n] * d, max_rank=rank, accuracy=acc, pivoting=piv)
    maybe_accchk(res, prob.fun)
    print(f"...with {res.neval} evaluations completed in {res.time:.4e} sec.")

    # complex contraction path with complex unit weights (dtt -> ztt
    # promotion + ztt_quad, test_crs_mvn_complex.f90:154-160); the
    # promotion happens inside contract as real/imag pair arithmetic
    w_complex = [prob.quad_weights.astype(np.complex128) * (1.0 + 0.0j)] * d
    val = complex(tt.contract(res.tt, w_complex))
    print(f"computed value: {val.real:.40e} {val.imag:.40e}")
    print(f"analytic value: {1.0:.40e}")
    print(f"correct digits: {-np.log10(abs(1 - val)):7.2f}")
    print("Good bye.")


if __name__ == "__main__":
    main()
