#!/usr/bin/env python
"""Batched parameter-family cross: `crs_batch.py D N RANK LANES [COMPARE]`

Crosses an MVN correlation family (corr linspace 0.2..0.7, LANES lanes,
each mass = 1) in ONE fused device program via cross_batch — the
device upgrade of launching the reference binary once per `par`
value (fun(m, ind, n, par), dmrgg.f90:18).  With COMPARE=1, also runs
each lane through the single-run engine and reports the family speedup
(on a latency-bound device the L-lane batch costs close to ONE run)."""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

import ttcross_tpu  # noqa: F401
from ttcross_tpu.apps.mvn import make_mvn_family
from ttcross_tpu.cross import cross, cross_batch
from ttcross_tpu.utils import print_config, readarg


def main():
    d = readarg(1, 6)
    n = readarg(2, 65)
    rank = readarg(3, 14)
    lanes = readarg(4, 4)
    compare = readarg(5, 0)

    corrs = np.linspace(0.2, 0.7, lanes)
    fam = make_mvn_family(d=d, n=n, corrs=corrs)
    print_config(dimension=d, quadratur=fam.n, TT_ranks=rank, lanes=lanes,
                 correlations=np.round(corrs, 3).tolist())
    acc = 500 * np.finfo(np.float64).eps

    res = cross_batch(fam.fun, [fam.n] * d, fam.params, max_rank=rank,
                      accuracy=acc, pivoting=1,
                      quad=[fam.quad_weights] * d, truth=1.0, verbose=True)
    print(f"family: {lanes} lanes, {res.neval} evaluations, "
          f"{res.time:.4e} sec total ({res.time / lanes:.4e} per lane)")
    for lane, r in enumerate(res):
        digits = -np.log10(abs(1.0 - r.values[-1]))
        print(f"  corr {corrs[lane]:.3f}: value {r.values[-1]:.12e} "
              f"correct digits {digits:6.2f} ranks {r.ranks}")

    if compare:
        # steady-state single-run comparison (second call of each; the
        # batch above already compiled, so re-time it steady too)
        t0 = time.time()
        res = cross_batch(fam.fun, [fam.n] * d, fam.params, max_rank=rank,
                          accuracy=acc, pivoting=1,
                          quad=[fam.quad_weights] * d, truth=1.0)
        batch_wall = time.time() - t0
        singles = 0.0
        for lane in range(lanes):
            par = {k: v[lane] for k, v in fam.params.items()}
            fun1 = lambda ind: fam.fun(ind, par)
            cross(fun1, [fam.n] * d, max_rank=rank, accuracy=acc,
                  pivoting=1, quad=[fam.quad_weights] * d, truth=1.0)
            t0 = time.time()
            cross(fun1, [fam.n] * d, max_rank=rank, accuracy=acc,
                  pivoting=1, quad=[fam.quad_weights] * d, truth=1.0)
            singles += time.time() - t0
        print(f"steady wall: batch {batch_wall:.3f} s vs {lanes} single runs "
              f"{singles:.3f} s -> family speedup {singles / batch_wall:.2f}x")
    print("Good bye.")


if __name__ == "__main__":
    main()
