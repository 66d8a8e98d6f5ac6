#!/usr/bin/env python
"""On-card smoke test: drive the cross engine's main path on an NVIDIA GPU.

    python chip_smoke.py                # one card, six phases
    python chip_smoke.py --four-cards   # four cards: bond mesh and lane mesh

The phases call the public API (`cross`, `cross_batch`, `cross_dd`,
`cross_parallel`) at the configurations the users of the reference run:
the north-star integral Ising C_6 at n=64 and rank 24
(`test_crs_ising.exe C 6 64 24 1`), the long chain C_256, an MVN family,
the double-double tier and full pivoting.  Each phase prints one JSON line
(correct digits, the floor they are held to, first-call seconds with
compilation, steady seconds, n_evals, the card's name and power limit).

The last line, printed only when every phase passed, is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
The script exits non-zero without that line when JAX finds no GPU, when
the package cannot be imported, or when a phase raises or falls below its
floor.  One process drives every card: it starts no child that opens one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

ACC = 500 * 2.2e-16       # the reference CLI's accuracy (dmrgg.f90 stop rule)

# Digit floors: a CPU run of each phase's configuration (JAX_PLATFORMS=cpu,
# commit 595b4d3; the engine edits made with this script leave the CPU
# digits bit-identical) less 0.5 digit.  The C_6 floors apply to the median over
# lottery keys 0-7 (CPU medians 12.34 greedy, 13.73 headline).
FLOORS = {
    "c6_greedy": 11.84,        # CPU median 12.3425
    "c6_headline": 13.22,      # CPU median 13.7288
    "c256_rb_chain": 10.11,    # CPU 10.6107
    "mvn_family": 3.23,        # CPU worst lane 3.7356
    "dd_c4": 18.23,            # CPU 18.7314 (rank-limited at rank 16)
    "dd_c4_r32": 30.56,        # CPU 31.0685 (the dd arithmetic limit)
    "full_pivot": 10.72,       # CPU 11.2250
}
KEYS = range(8)          # lottery keys of the C_6 phases
AGREE_DIGITS = 0.5        # reduction order (cuBLAS against Eigen) can flip a
                          # near-tied greedy pivot; half a digit covers it
# The one-card family is one program over 4 lanes; each card of the lane
# mesh runs a 1-lane block, and XLA picks kernels, and so summation
# orders, by shape.  On the H100 the lanes differed by up to 3.5e-12
# relative (the corr-0.6 lane, whose own error is 1.6e-6).
LANE_REL_TOL = 1e-11


def nvidia_smi() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit` lines (one per card)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [s.strip() for s in out.stdout.splitlines() if s.strip()]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def digits(err: float) -> float:
    return float(-np.log10(err)) if err > 0 else 17.0


def timed(run):
    """(result, first-call seconds, steady seconds).  Every entry point
    returns after copying its packed result to the host, which waits for
    the device; block_until_ready covers any array left on it."""
    import jax

    t = time.perf_counter()
    res = jax.block_until_ready(run())
    first = time.perf_counter() - t
    t = time.perf_counter()
    res = jax.block_until_ready(run())
    return res, first, time.perf_counter() - t


def ising_args(p, **kw):
    return dict(max_rank=24, accuracy=ACC, pivoting=1,
                quad=[p.quad_weights] * p.d, truth=p.truth) | kw


# ------------------------------------------------------------ one card

def phase_c6_greedy(cpu):
    """The reference CLI `C 6 64 24 1`, at lottery keys 0-7, on the card
    and again on the CPU backend in this process.  One key's digits hinge
    on near-tied pivots that reduction order flips (key 0: 12.75 on the
    card against 12.54 on the CPU, one rank apart), so the two backends
    are compared, and the floor applied, over the median of the keys."""
    import jax

    from ttcross_tpu.apps import make_ising
    from ttcross_tpu.cross import cross

    p = make_ising("C", m=6, n=64)

    def run(key=0):
        return cross(p.fun, [p.n] * p.d, key=key, **ising_args(p))

    res, first, steady = timed(run)
    # first call again with the in-memory executables dropped: compiles
    # now come from the persistent compilation cache the first call filled
    jax.clear_caches()
    t = time.perf_counter()
    run()
    warm_first = time.perf_counter() - t
    gpu = [run(k) for k in KEYS]
    with jax.default_device(cpu):
        cpu_steady = timed(run)[2]
        host = [run(k) for k in KEYS]
    dg = [digits(r.errors[-1]) for r in gpu]
    dc = [digits(r.errors[-1]) for r in host]
    checks = {"median_digits_agree": abs(np.median(dg) - np.median(dc)) <= AGREE_DIGITS,
              "max_ranks_match": all(max(a.ranks) == max(b.ranks)
                                     for a, b in zip(gpu, host))}
    return (float(np.median(dg)), res.neval), first, steady, dict(
        first_call_warm_cache_s=warm_first, key0_digits=dg[0],
        key_digits=dg, cpu_key_digits=dc, cpu_steady_s=cpu_steady,
        ranks_equal_keys=sum(a.ranks == b.ranks for a, b in zip(gpu, host)),
        key0_ranks=list(gpu[0].ranks), cpu_key0_ranks=list(host[0].ranks)), checks


def phase_c6_headline(cpu):
    """bench.py's headline: cross at rank 30, host re-evaluation of the
    skeleton, TT-SVD rounding to 24; held to its floor over the median of
    lottery keys 0-7 (one key's digits spread 13.1-14.3 on the CPU).  The
    device-valued reading (host_reeval=False) is printed beside it."""
    from ttcross_tpu.apps import make_ising
    from ttcross_tpu.cross import cross

    p = make_ising("C", m=6, n=64)

    def run(key=0, host_reeval=True):
        return cross(p.fun, [p.n] * p.d, oversample=6, host_reeval=host_reeval,
                     key=key, **ising_args(p))

    res, first, steady = timed(run)
    dev_steady = timed(lambda: run(host_reeval=False))[2]
    dg = [digits(run(k).errors[-1]) for k in KEYS]
    dv = [digits(run(k, host_reeval=False).errors[-1]) for k in KEYS]
    return (float(np.median(dg)), res.neval), first, steady, dict(
        key0_digits=dg[0], key_digits=dg,
        device_valued_median_digits=float(np.median(dv)),
        device_valued_key_digits=dv, device_valued_steady_s=dev_steady), {}


def phase_c256_rb_chain(cpu):
    """The long chain: d=255, red-black jacobi sweeps, chain-spec hunt."""
    from ttcross_tpu.apps import make_ising
    from ttcross_tpu.cross import cross

    p = make_ising("C", m=256, n=17)
    res, first, steady = timed(lambda: cross(
        p.fun, [p.n] * p.d, **ising_args(p, max_rank=10, sweep_mode="jacobi-rb",
                                         chain=p.chain)))
    return res, first, steady, dict(sweeps=res.sweeps), {}


def mvn_family_setup():
    from ttcross_tpu.apps.mvn import make_mvn_family

    fam = make_mvn_family(d=6, n=65, corrs=np.linspace(0.2, 0.6, 4))
    args = dict(max_rank=20, accuracy=ACC, pivoting=1,
                quad=[fam.quad_weights] * 6, truth=1.0)
    return fam, args


def phase_mvn_family(cpu):
    """Four MVN lanes in one program; each lane against its own cross."""
    import jax

    from ttcross_tpu.cross import cross, cross_batch

    fam, args = mvn_family_setup()
    resb, first, steady = timed(lambda: cross_batch(
        fam.fun, [fam.n] * 6, fam.params, key=0, **args))
    lane_digits = [digits(r.errors[-1]) for r in resb]
    # cross_batch gives lane l the key split(PRNGKey(0), L)[l]
    keys = jax.random.split(jax.random.PRNGKey(0), len(resb))
    single_digits = []
    for lane in range(len(resb)):
        par = {k: v[lane] for k, v in fam.params.items()}
        r1 = cross(lambda ind, par=par: fam.fun(ind, par), [fam.n] * 6,
                   key=keys[lane], **args)
        single_digits.append(digits(r1.errors[-1]))
    worst = min(lane_digits)
    checks = {"lanes_agree_with_singles": all(
        abs(a - b) <= AGREE_DIGITS for a, b in zip(lane_digits, single_digits))}
    return (worst, resb.neval), first, steady, dict(
        lane_digits=lane_digits, single_digits=single_digits), checks


def phase_dd_c4(cpu):
    """The double-double engine on Ising C_4 against the 60-digit truth."""
    from decimal import Decimal, localcontext

    from ttcross_tpu import native
    from ttcross_tpu.apps.ising import make_ising_dd
    from ttcross_tpu.apps.truths import ISING_C_STR
    from ttcross_tpu.cross.engine_dd import cross_dd

    # without the native __float128 rule the dd nodes fall back to f64
    # with zero low parts, which caps the digits silently
    if not native.available():
        raise RuntimeError("native library (g++ -lquadmath) unavailable")
    prob, fun_dd, wh, wl = make_ising_dd(m=4, n=33)
    res, first, steady = timed(lambda: cross_dd(
        fun_dd, [prob.n] * prob.d, wh, wl, max_rank=16, pivoting=1))
    with localcontext() as ctx:
        ctx.prec = 60
        got = Decimal(float(res.value[0])) + Decimal(float(res.value[1]))
        rel = abs(1 - got / Decimal(ISING_C_STR[4]))
        dd_digits = float(-rel.log10()) if rel != 0 else 60.0
    return (dd_digits, res.neval), first, steady, {}, {}


def phase_dd_c4_r32(cpu):
    """The dd engine at its arithmetic limit (C_4, n=65, rank 32, ~31
    digits): the digits past ~19 hold only while the Dekker products of
    ops/dd.py stay exact, so this phase catches an FMA contraction or a
    product that is not correctly rounded on the card."""
    from decimal import Decimal, localcontext

    from ttcross_tpu import native
    from ttcross_tpu.apps.ising import make_ising_dd
    from ttcross_tpu.apps.truths import ISING_C_STR
    from ttcross_tpu.cross.engine_dd import cross_dd

    if not native.available():
        raise RuntimeError("native library (g++ -lquadmath) unavailable")
    prob, fun_dd, wh, wl = make_ising_dd(m=4, n=65)
    res, first, steady = timed(lambda: cross_dd(
        fun_dd, [prob.n] * prob.d, wh, wl, max_rank=32, pivoting=1))
    with localcontext() as ctx:
        ctx.prec = 60
        got = Decimal(float(res.value[0])) + Decimal(float(res.value[1]))
        rel = abs(1 - got / Decimal(ISING_C_STR[4]))
        dd_digits = float(-rel.log10()) if rel != 0 else 60.0
    return (dd_digits, res.neval), first, steady, {}, {}


def phase_full_pivot(cpu):
    """pivoting=-1 (superblock residual argmax, plain f64) at C_4, plus
    the time of one full-pivoting bond visit at the C_6 rank-24
    superblock (24*64*64*24 entries)."""
    import jax

    from ttcross_tpu.apps import make_ising
    from ttcross_tpu.config import precision_thresholds
    from ttcross_tpu.cross import cross, make_engine
    from ttcross_tpu.cross.engine import CrossConfig

    p = make_ising("C", m=4, n=33)
    res, first, steady = timed(lambda: cross(
        p.fun, [p.n] * p.d, **ising_args(p, max_rank=8, pivoting=-1)))

    p6 = make_ising("C", m=6, n=64)
    se, sp = precision_thresholds()
    kit = make_engine(p6.fun, CrossConfig(d=p6.d, n=(p6.n,) * p6.d, N=p6.n,
                                          R=24, piv=-1, small_element=se,
                                          small_pivot=sp))
    st = kit.init_fn(jax.random.PRNGKey(0))
    visit = jax.jit(lambda s: kit.visit_bond(s, 1, True))
    jax.block_until_ready(visit(st))
    times = []
    for _ in range(10):
        t = time.perf_counter()
        jax.block_until_ready(visit(st))
        times.append(time.perf_counter() - t)
    return res, first, steady, dict(
        c6_r24_full_pivot_visit_s=float(np.median(times))), {}


ONE_CARD = [phase_c6_greedy, phase_c6_headline, phase_c256_rb_chain,
            phase_mvn_family, phase_dd_c4, phase_dd_c4_r32, phase_full_pivot]


# ---------------------------------------------------------- four cards

def _allocs(devs):
    """Per-card allocation counters: a card that held a slab or a lane
    shows new allocations."""
    stats = [d.memory_stats() or {} for d in devs]
    return [st.get("num_allocs", st.get("peak_bytes_in_use", 0)) for st in stats]


def phase_bond_mesh(devs):
    """cross_parallel over a 4-card bond mesh at the C_256 rb-chain
    configuration against the same cross on card 0."""
    import jax

    from ttcross_tpu.apps import make_ising
    from ttcross_tpu.cross import cross
    from ttcross_tpu.parallel import bond_mesh, cross_parallel

    p = make_ising("C", m=256, n=17)
    args = ising_args(p, max_rank=10, sweep_mode="jacobi-rb", chain=p.chain)
    mesh = bond_mesh(devs)      # one mesh: the engine is cached per mesh
    before = _allocs(devs)
    res, first, steady = timed(lambda: cross_parallel(
        p.fun, [p.n] * p.d, mesh=mesh, **args))
    used = [a > b for a, b in zip(_allocs(devs), before)]
    with jax.default_device(devs[0]):
        ref = cross(p.fun, [p.n] * p.d, **args)
    rel = abs(res.values[-1] / ref.values[-1] - 1.0)
    checks = {"digits_agree": abs(digits(res.errors[-1]) - digits(ref.errors[-1]))
              <= AGREE_DIGITS,
              "values_agree_1e-10": rel <= 1e-10,
              "every_card_used": all(used)}
    return res, first, steady, dict(
        one_card_digits=digits(ref.errors[-1]), rel_value_diff=rel,
        cards_used=used), checks


def phase_lane_mesh(devs):
    """A 4-lane cross_batch sharded one lane per card against the
    unsharded family on card 0."""
    import jax
    from jax.sharding import Mesh

    from ttcross_tpu.cross import cross_batch

    fam, args = mvn_family_setup()
    mesh = Mesh(np.asarray(devs), ("lane",))   # the runner is cached per mesh
    before = _allocs(devs)
    res, first, steady = timed(lambda: cross_batch(
        fam.fun, [fam.n] * 6, fam.params, mesh=mesh, **args))
    used = [a > b for a, b in zip(_allocs(devs), before)]
    with jax.default_device(devs[0]):
        ref = cross_batch(fam.fun, [fam.n] * 6, fam.params, **args)
    rels = [abs(a.values[-1] / b.values[-1] - 1.0) for a, b in zip(res, ref)]
    checks = {"lanes_agree": max(rels) <= LANE_REL_TOL,
              "every_card_used": all(used)}
    worst = min(digits(r.errors[-1]) for r in res)
    return (worst, res.neval), first, steady, dict(
        rel_value_diffs=rels, cards_used=used), checks


FOUR_CARDS = [phase_bond_mesh, phase_lane_mesh]


# ---------------------------------------------------------------- main

def run_phase(phase, arg, card):
    name = phase.__name__.removeprefix("phase_")
    try:
        res, first, steady, extra, checks = phase(arg)
    except Exception:
        traceback.print_exc()
        emit({"phase": name, "ok": False, "error": traceback.format_exc(limit=3)[-600:],
              "card": card})
        return False
    checks = {k: bool(v) for k, v in checks.items()}
    if isinstance(res, tuple):
        dig, n_evals = res
    else:
        dig, n_evals = digits(res.errors[-1]), res.neval
    floor = FLOORS.get(name)
    ok = all(checks.values()) and (floor is None or dig >= floor)
    emit({"phase": name, "ok": ok, "digits": dig, "floor": floor,
          "first_s": first, "steady_s": steady, "compile_s": first - steady,
          "n_evals": int(n_evals), **extra, "checks": checks, "card": card})
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card bond-mesh and lane-mesh checks")
    args = ap.parse_args(argv)

    smi = nvidia_smi()
    emit({"nvidia_smi": smi[0] if smi else None, "cards": smi})
    import jax

    print(jax.devices(), flush=True)
    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's default backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 1
    import ttcross_tpu  # noqa: F401  (x64 + compile-cache placement)

    card = smi[0] if smi else None
    devs = jax.devices()
    if args.four_cards:
        if len(devs) < 4:
            print(f"--four-cards needs 4 GPUs, found {len(devs)}", file=sys.stderr)
            return 1
        oks = [run_phase(ph, devs[:4], card) for ph in FOUR_CARDS]
    else:
        cpu = jax.devices("cpu")[0]
        oks = [run_phase(ph, cpu, card) for ph in ONE_CARD]
    if not all(oks):
        return 1
    d = devs[0]
    emit({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                 "count": len(devs)}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
