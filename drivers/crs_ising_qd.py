#!/usr/bin/env python
"""Very-high-precision Ising C_m by THREE-level qd defect-corrected cross:
`crs_ising_qd.py INDEX N RANK1 RANK2 LEVELS`.

The quad-double extension of crs_ising_dd.py (the reference's
test_mpf_ising role, README.md:52): every cross runs in the fast f64
device engine; the correction levels cross the defect A_qd - sum TT_i
evaluated in quad-double (~62-digit) arithmetic (ops/qd.py), and the
final quadratures contract in qd.

The defect of an f64 train is NOISE-LIKE (core rounding is effectively
full-rank), so the correction levels only bite at (near-)full rank2.
Measured on C_4 (d=3, n=33, levels=3): 33.7 digits at rank2=33 (full),
22.0 at rank2=30, vs the dd ENGINE's ~31.  For a true high-precision
cross at ranks far below full, use cross_dd (~31 digits, device) or
cross_mp (120 digits, host).  Full qd precision needs a correctly-rounded f64
multiply: run on the CPU platform (JAX_PLATFORMS=cpu is forced below,
like the mp driver)."""

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
from ttcross_tpu.cross.defect import cross_defect_corrected_qd
from ttcross_tpu.ops.qd import qd_to_mp
from ttcross_tpu.utils import print_config, readarg


def main():
    from mpmath import mp, mpf, workdps

    m = readarg(1, 4)
    n = readarg(2, 33)
    r1 = readarg(3, 16)
    r2 = readarg(4, 33)   # full rank for the default n=33: see module doc
    levels = readarg(5, 3)

    prob, fun_qd, wq = make_ising_qd(m=m, n=n)
    print_config(integral=f"C_{m}", quadratur=prob.n, rank1=r1, rank2=r2,
                 levels=levels, tier="defect-corrected qd")
    limbs, info = cross_defect_corrected_qd(
        prob.fun, fun_qd, [prob.n] * prob.d, wq,
        max_rank=r1, max_rank2=r2, levels=levels)
    with workdps(70):
        got = qd_to_mp(*limbs)
        print(f"computed value: {mp.nstr(got, 60)}")
        print(f"evaluations   : {info['nevals']}")
        if m in ISING_C_STR:
            tru = mpf(ISING_C_STR[m])
            rel = abs(1 - got / tru)
            digits = float(-mp.log10(rel)) if rel != 0 else 70.0
            print(f"analytic value: {mp.nstr(tru, 60)}")
            print(f"correct digits: {digits:7.2f}")
    print("Good bye.")


if __name__ == "__main__":
    main()
