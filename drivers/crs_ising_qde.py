#!/usr/bin/env python
"""Very-high-precision Ising C_m with the quad-double ENGINE:
`crs_ising_qde.py INDEX N RANK PIV WORKERS`.

WORKERS > 1 runs the bond-slab-distributed qd cross over forked host
worker processes (parallel/engine_qd.py — the qd rendering of
mptt_dmrgg's MPI mode, dmrggmp.f90:518-629).

The ~62-digit point on the mptt_dmrgg tier ladder (the reference's
test_mpf_ising role, README.md:52): the full cross — every fiber,
factor, residual hunt, bordered inverse, and quadrature — runs in
vectorized quad-double arithmetic (cross/engine_qd.py, a numpy SoA
mirror of the mpmath engine).  Measured vs Bailey's 500-digit
constants: C_4 n=65 rank 55 -> 64.2 correct digits in 63 s / 229k
evaluations on one CPU core — double the dd engine's ~31-digit
arithmetic limit, and 2.3x faster than cross_mp at dps=70 on the
identical config (147 s to 64.8 digits).  Full qd precision needs a
correctly-rounded f64
multiply: CPU platform is forced below (like the mp/qd defect
drivers)."""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
import jax._src.xla_bridge as _xb

_xb._clear_backends()

import ttcross_tpu  # noqa: F401
from ttcross_tpu.apps.ising import make_ising_qd
from ttcross_tpu.apps.truths import ISING_C_STR
from ttcross_tpu.cross.engine_qd import cross_qd
from ttcross_tpu.ops.qd import qd_to_string
from ttcross_tpu.utils import print_config, readarg


def main():
    from mpmath import mp, mpf, workdps

    from ttcross_tpu.ops.qd import qd_to_mp

    m = readarg(1, 4)
    n = readarg(2, 65)
    rank = readarg(3, 33)
    piv = readarg(4, 1)
    workers = readarg(5, 1)

    prob, fun_qd, wq = make_ising_qd(m=m, n=n)
    print_config(integral=f"C_{m}", quadratur=prob.n, TT_ranks=rank,
                 tier="quad-double engine", workers=workers)
    if workers > 1:
        from ttcross_tpu.parallel.engine_qd import cross_qd_parallel

        res = cross_qd_parallel(fun_qd, [prob.n] * prob.d, max_rank=rank,
                                pivoting=piv, quad=wq,
                                truth=ISING_C_STR.get(m), verbose=True,
                                n_workers=workers)
    else:
        res = cross_qd(fun_qd, [prob.n] * prob.d, max_rank=rank,
                       pivoting=piv, quad=wq, truth=ISING_C_STR.get(m),
                       verbose=True)
    print(f"computed value: {qd_to_string(res.value, 65)}")
    print(f"...with {res.neval} qd evaluations, ranks {res.ranks}")
    if m in ISING_C_STR:
        import numpy as np

        with workdps(70):
            got = qd_to_mp(*(np.asarray(e) for e in res.value))
            tru = mpf(ISING_C_STR[m])
            rel = abs(1 - got / tru)
            digits = float(-mp.log10(rel)) if rel != 0 else 70.0
            print(f"analytic value: {mp.nstr(tru, 65)}")
            print(f"correct digits: {digits:7.2f}")
    print("Good bye.")


if __name__ == "__main__":
    main()
