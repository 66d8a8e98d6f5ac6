#!/usr/bin/env python
"""High-precision Ising C_m by defect-corrected cross:
`crs_ising_dd.py INDEX N RANK1 RANK2`.

The mp-tier pipeline (the reference's test_mpf_ising role, README.md:52)
re-architected for the device: both crosses run in the fast f64 device engine; the
second one crosses the DEFECT A_dd - TT1 evaluated in device double-double
arithmetic; quadratures contract in __float128.  Measured: C_6 to 16.0
digits at ranks (32,48), 17.0 at (40,64) — past any pure-f64 pipeline."""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from decimal import Decimal, getcontext

import ttcross_tpu  # noqa: F401
from ttcross_tpu import native
from ttcross_tpu.apps.ising import make_ising_dd
from ttcross_tpu.apps.truths import ISING_C_STR
from ttcross_tpu.cross.defect import cross_defect_corrected
from ttcross_tpu.utils import print_config, readarg


def main():
    m = readarg(1, 6)
    n = readarg(2, 65)
    r1 = readarg(3, 32)
    r2 = readarg(4, 48)
    if not native.available():
        print("native toolchain unavailable; the dd tier needs it")
        return 1

    prob, fun_dd, wh, wl = make_ising_dd(m=m, n=n)
    print_config(integral=f"C_{m}", quadratur=prob.n, rank1=r1, rank2=r2,
                 tier="defect-corrected dd")
    hi, lo, info = cross_defect_corrected(prob.fun, fun_dd, [prob.n] * prob.d,
                                          wh, wl, max_rank=r1, max_rank2=r2)
    getcontext().prec = 60
    got = Decimal(hi) + Decimal(lo)
    print(f"computed value: {got}")
    print(f"evaluations   : {info['neval1']} + {info['neval2']} (defect)")
    if m in ISING_C_STR:
        tru = Decimal(ISING_C_STR[m])
        rel = abs(1 - got / tru)
        digits = float(-rel.log10()) if rel != 0 else 60.0
        print(f"analytic value: {tru}")
        print(f"correct digits: {digits:7.2f}")
    print("Good bye.")


if __name__ == "__main__":
    main()
