#!/usr/bin/env python
"""Benchmark driver: the five BASELINE.md configs + the C_6 north-star
headline (test_crs_ising.exe C 6 64 24 1), on one NVIDIA GPU.

    python bench.py              # every config; exits non-zero if one raised
    python bench.py --parallel   # distributed engine on a virtual CPU mesh

Prints one JSON line per config, and the HEADLINE line LAST:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}
Every line carries the device it ran on (platform, device_kind, count)
and the card's `nvidia-smi` name and power limit.  Without a GPU the
bench exits non-zero before measuring anything.

Ordering:

  1. ONE fresh subprocess runs the FULL headline config first, while this
     process has not opened the card (a JAX process reserves most of the
     card's memory, so two cannot share it).  Its time-to-first-result is
     warmup sample #1, and its headline JSON is re-emitted at once.
  2. Extra fresh-process warmup probes run only inside a total wall-clock
     budget (TTCROSS_BENCH_WARMUP_BUDGET_S, default 450 s, shared with
     step 1; K capped by TTCROSS_BENCH_WARMUP_K, default 2 = the headline
     probe + one greedy probe).
  3. Then this process opens the card and runs the companion configs
     under a soft deadline (TTCROSS_BENCH_DEADLINE_S, default 1500 s):
     once past it, remaining configs are skipped with "skipped" lines.
  4. The steady-state headline is re-measured in-process and emitted as
     the LAST line.

vs_baseline: measured against the same-host C++17+OpenMP reference twin
(baseline/, a faithful dtt_dmrgg port), re-measured LIVE in this bench's
wall-clock window (run_baseline.py --live), falling back to
baseline/measured.json, then to NOMINAL_REF_EVALS_PER_SEC with
baseline_nominal=true.  Lines stamp baseline_source accordingly.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

NOMINAL_REF_EVALS_PER_SEC = 1.0e6
HEADLINE_PROBE_TIMEOUT_S = 900


def _baseline_measured():
    """baseline/measured.json contents (same-host C++ twin) or None."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline", "measured.json")
    try:
        with open(path) as f:
            return json.load(f)
    except Exception:
        return None


_LIVE_BASELINE = {"ran": False, "data": None}


def _baseline_live():
    """Re-measure the C++ twin NOW, in the same wall-clock window as the
    bench (median-of-3 per config).  The virtualized host's CPU share
    swings the SAME binary 3.0-8.8M evals/s on ising_c6 across hours
    (measured 2026-08-19), so a stale measured.json can skew vs_baseline
    ~2x either way; the same-window number cannot.  One subprocess,
    cached; ~10 s typical, hard 240 s timeout; None on any failure
    (callers fall back to measured.json)."""
    if _LIVE_BASELINE["ran"]:
        return _LIVE_BASELINE["data"]
    _LIVE_BASELINE["ran"] = True
    if os.environ.get("TTCROSS_BENCH_LIVE_BASELINE", "1") in ("0", "false"):
        return None
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "baseline", "run_baseline.py")
    try:
        proc = subprocess.run(
            [sys.executable, script, "--live",
             "ising_c6,ising_c256,ising_c1024", "2"],
            capture_output=True, text=True, timeout=300, check=True)
        data = json.loads(proc.stdout.splitlines()[-1])
        _emit({"metric": "baseline_live", **{
            k: v for k, v in data.items() if k != "measured_at"}})
        _LIVE_BASELINE["data"] = data
    except Exception as exc:
        _emit({"metric": "baseline_live", "ok": False, "error": repr(exc)[:200]})
    return _LIVE_BASELINE["data"]


def _baseline_config(key):
    """Same-window live measurement for `key` if available, else the
    checked-in measured.json entry, else None.  Returns (entry, source)."""
    live = _baseline_live()
    if live and key in live:
        return live[key], "live"
    data = _baseline_measured()
    if data and key in data:
        return data[key], "measured.json"
    return None, None


def _baseline_evals_per_sec():
    """Measured same-host baseline (C++ reference twin) if available."""
    entry, _src = _baseline_config("ising_c6")
    try:
        v = float(entry["evals_per_sec"])
        if v > 0:
            return v, False
    except Exception:
        pass
    return NOMINAL_REF_EVALS_PER_SEC, True


def nvidia_smi():
    """The card's `name, power.limit` as nvidia-smi reports them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


# device stamp merged into every emitted line (filled at start-up and by
# _open_device)
_STAMP = {}


def _emit(obj):
    print(json.dumps({**obj, **_STAMP}), flush=True)


def _open_device():
    """Open the card in this process and stamp every later line with it.
    Returns False (after saying why) when JAX's default backend is not a
    GPU: a CPU number must never pass for a card number."""
    import jax

    if jax.default_backend() != "gpu":
        print(f"bench.py needs a GPU; JAX's default backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return False
    d = jax.devices()[0]
    _STAMP.update(platform=d.platform, device_kind=d.device_kind,
                  count=len(jax.devices()))
    return True


class _SkipConfig(Exception):
    """Internal marker: config intentionally skipped (headline-only mode)."""


def _headline_payload(res, elapsed):
    """The headline JSON fields shared by the fresh-process probe and the
    parent's final steady-state line."""
    digits = -np.log10(res.errors[-1])
    n_evals = int(res.neval)
    evals_per_sec = n_evals / elapsed
    base_eps, nominal = _baseline_evals_per_sec()
    t_hit = next((i for i, e in enumerate(res.errors) if e <= 1e-10), None)
    out = {
        "metric": "ising_c6_evals_per_sec",
        "value": round(evals_per_sec, 1),
        "unit": "evals/sec",
        "vs_baseline": round(evals_per_sec / base_eps, 3),
        "correct_digits": round(float(digits), 2),
        "n_evals": n_evals,
        "wall_time_s": round(elapsed, 3),
        "sweeps": res.sweeps,
        "first_sweep_below_1e-10": t_hit,
        "max_rank": 24,
        "oversample": 6,
        # host_reeval=True: the host twin is AUTO-DERIVED (the traced
        # integrand re-run on the CPU x64 backend — no hand-written numpy
        # integrand; skeleton.py::derive_host_fun)
        "host_reeval": True,
        # honesty metrics: n_evals counts ACTIVE entries (the reference's
        # bookkeeping, dmrgg.f90:372,465,...) PLUS the host skeleton
        # re-samples; padded_evals COUNTS (in CrossState, not estimates)
        # every integrand call incl. masked padding slots + the re-samples
        "padded_evals": int(res.padded_evals),
        "padded_ratio": round(res.padded_evals / n_evals, 2),
    }
    if nominal:
        out["baseline_nominal"] = True
    else:
        # the measured same-host comparable (a C++17+OpenMP twin of
        # dtt_dmrgg), re-measured LIVE in this bench's wall-clock window
        # when possible (host CPU share swings ~3x across hours): note it
        # is the GREEDY algorithm at rank 24 — its digits cap at the
        # greedy ceiling (~11.9 on this config) while this headline's
        # oversample+host_reeval pipeline reaches 14+; vs_baseline
        # compares raw integrand throughput
        data, src = _baseline_config("ising_c6")
        out["baseline_evals_per_sec"] = data["evals_per_sec"]
        out["baseline_digits"] = data["correct_digits"]
        out["baseline_wall_s"] = data["wall_time_s"]
        out["baseline_threads"] = data["threads"]
        out["baseline_source"] = src
    return out


def _run_headline(cross, prob, acc):
    args = dict(max_rank=24, accuracy=acc, pivoting=1,
                quad=[prob.quad_weights] * prob.d, truth=prob.truth)
    return lambda: cross(prob.fun, [prob.n] * prob.d, oversample=6,
                         host_reeval=True, **args)


def headline_probe():
    """Child mode: fresh-process FULL headline run.  Prints the headline
    JSON (stage=fresh_process) whose wall_time_s is time-to-first-result —
    the warmup sample — plus a steady re-run time."""
    t0 = time.time()
    if not _open_device():
        return 1
    import ttcross_tpu  # noqa: F401
    from ttcross_tpu.apps import make_ising
    from ttcross_tpu.cross import cross

    prob = make_ising("C", m=6, n=64)
    run = _run_headline(cross, prob, 500 * 2.2e-16)
    res = run()
    first = time.time() - t0
    t0 = time.time()
    res = run()
    steady = time.time() - t0
    out = _headline_payload(res, steady)
    out["stage"] = "fresh_process"
    out["probe_warmup_s"] = round(first, 3)
    _emit(out)
    return 0


def run_headline_probe_subprocess(timeout_s):
    """Run the fresh-process headline (warmup probe #1 + early headline).
    Returns (headline_json_or_None, warmup_seconds_or_None)."""
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--headline-probe"],
            capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        _emit({"metric": "headline_probe", "timeout_s": timeout_s})
        return None, float(timeout_s)
    for line in reversed(proc.stdout.splitlines()):
        try:
            obj = json.loads(line)
        except Exception:
            continue
        if obj.get("metric") == "ising_c6_evals_per_sec":
            _emit(obj)   # EARLY headline: in the artifact from minute one
            return obj, float(obj.get("probe_warmup_s") or time.time() - t0)
    _emit({"metric": "headline_probe", "failed_rc": proc.returncode,
           "stderr_tail": proc.stderr[-160:]})
    return None, None


def warmup_probe():
    """Child mode: fresh-process time-to-first-result on the north star
    (greedy config — the classic warmup probe, cheaper than the full
    headline; used for the tail-robustness samples)."""
    t0 = time.time()
    if not _open_device():
        return 1
    import ttcross_tpu  # noqa: F401
    from ttcross_tpu.apps import make_ising
    from ttcross_tpu.cross import cross

    prob = make_ising("C", m=6, n=64)
    res = cross(prob.fun, [prob.n] * prob.d, max_rank=24,
                accuracy=500 * 2.2e-16, pivoting=1,
                quad=[prob.quad_weights] * prob.d, truth=prob.truth)
    _emit({"probe_warmup_s": round(time.time() - t0, 3),
           "digits": round(float(-np.log10(res.errors[-1])), 2)})
    return 0


def run_extra_warmup_probes(budget_s, first_sample):
    """Sequential fresh-process probes AFTER the headline probe, bounded
    by the remaining wall-clock budget (round-3 lesson: unbounded probes
    at 370-540 s each starved the artifact of its headline)."""
    k = int(os.environ.get("TTCROSS_BENCH_WARMUP_K", "2")) - 1
    times = [] if first_sample is None else [first_sample]
    failures = 1 if first_sample is None else 0
    spent = sum(times)
    for i in range(max(k, 0)):
        remaining = budget_s - spent
        if remaining < 30:
            _emit({"metric": "warmup_probe", "sample": i + 1,
                   "skipped": f"budget exhausted ({round(remaining)}s left)"})
            break
        t0 = time.time()
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--warmup-probe"],
                capture_output=True, text=True, timeout=remaining)
            samp = None
            if proc.returncode == 0:
                for line in reversed(proc.stdout.splitlines()):
                    try:
                        samp = json.loads(line).get("probe_warmup_s")
                        break
                    except Exception:
                        continue
            if samp is None:
                failures += 1
                samp = time.time() - t0
            times.append(float(samp))
        except subprocess.TimeoutExpired:
            failures += 1
            times.append(time.time() - t0)
        spent += time.time() - t0
        _emit({"metric": "warmup_probe", "sample": i + 1,
               "seconds": round(times[-1], 2)})
    if not times:
        return None, None, failures
    return (round(statistics.median(times), 2), round(max(times), 2), failures)


def _timed(fn):
    """(warm, timed) pair: first call pays compile, second is steady."""
    t0 = time.time()
    fn()
    warm = time.time() - t0
    t0 = time.time()
    res = fn()
    return res, time.time() - t0, warm


def main():
    t_start = time.time()
    deadline_s = float(os.environ.get("TTCROSS_BENCH_DEADLINE_S", "1500"))
    if _STAMP.get("nvidia_smi") is None:
        print("bench.py needs an NVIDIA GPU; nvidia-smi found none",
              file=sys.stderr)
        return 1

    # 1) fresh-process headline FIRST, while this process has not opened
    #    the card.  The output holds a full headline line even if
    #    everything after this point times out.  Doubles as warmup
    #    sample #1.
    warm_med = warm_tail = None
    probe_failures = 0
    budget_s = float(os.environ.get("TTCROSS_BENCH_WARMUP_BUDGET_S", "450"))
    early_headline, first_sample = run_headline_probe_subprocess(
        min(HEADLINE_PROBE_TIMEOUT_S, budget_s))
    # 2) extra tail-robustness probes inside the remaining budget
    if int(os.environ.get("TTCROSS_BENCH_WARMUP_K", "2")) > 1:
        warm_med, warm_tail, probe_failures = run_extra_warmup_probes(
            budget_s, first_sample)
    elif first_sample is not None:
        warm_med = warm_tail = round(first_sample, 2)

    # 3) only now does this process open the card
    if not _open_device():
        return 1
    import ttcross_tpu  # noqa: F401  (x64)
    import ttcross_tpu.tt as tt
    from ttcross_tpu.apps import (make_cos_coefficients, make_ising,
                                  make_mvn, make_mvn_density, make_stdnorm)
    from ttcross_tpu.cross import cross
    from ttcross_tpu.cross.accchk import accchk

    acc = 500 * 2.2e-16
    failed = [] if early_headline is not None else ["headline_probe"]

    def line(metric, res, elapsed, extras=None):
        digits = (-np.log10(res.errors[-1])) if res.errors else None
        out = {
            "metric": metric,
            "evals_per_sec": round(res.neval / elapsed, 1),
            "correct_digits": (round(float(digits), 2)
                               if digits is not None else None),
            "n_evals": int(res.neval),
            "wall_time_s": round(elapsed, 3),
            "sweeps": res.sweeps,
            "max_rank": max(res.ranks),
        }
        if res.padded_evals:
            out["padded_ratio"] = round(res.padded_evals / res.neval, 2)
        out.update(extras or {})
        _emit(out)
        return out

    def guarded(name, body):
        """Run one config block; a failure emits an error line and marks
        the run failed (exit code 1), but the suite continues so the
        HEADLINE line at the end is still attempted.  Past the soft
        deadline, configs are skipped."""
        if time.time() - t_start > deadline_s:
            _emit({"metric": name,
                   "skipped": f"soft deadline {deadline_s}s reached"})
            return None
        try:
            return body()
        except Exception as e:
            failed.append(name)
            _emit({"metric": name, "error": repr(e)[:300]})
            return None

    # ---- config 1: stdnorm d=10 N=33 RANK=8 (test_crs_stdnorm.exe 10 32 8 1)
    def config_stdnorm():
        p1 = make_stdnorm(d=10, n=32)
        q1 = dict(max_rank=8, accuracy=5 * 2.2e-16, pivoting=1,
                  quad=[p1.quad_weights] * p1.d, truth=p1.truth)
        res, el, _ = _timed(lambda: cross(p1.fun, [p1.n] * p1.d, **q1))
        line("stdnorm_d10", res, el)
        # (cross(adaptive=True) is deliberately NOT a bench line: it is an
        # evaluation-BUDGET feature — 28% fewer integrand calls on this
        # config at identical digits — but the per-bond lax.cond gating
        # may cost more wall time than the skipped fibers save on cheap
        # traced integrands (and accept-heavy runs like coscoeff gate
        # nothing).  It pays off only when each
        # integrand call has real cost outside the device program, e.g.
        # host-callback integrands.)

    # ---- config 2: MVN probability d=6 N=65 RANK=20 (test_crs_mvn.exe)
    def config_mvn():
        p2 = make_mvn(d=6, n=65)
        q2 = dict(max_rank=20, accuracy=acc, pivoting=1,
                  quad=[p2.quad_weights] * p2.d, truth=p2.truth)
        res, el, _ = _timed(lambda: cross(p2.fun, [p2.n] * p2.d, **q2))
        line("mvn_d6", res, el)
        return p2, res, el

    # ---- config 3: COS coefficient tensor (test_crs_coscoeff.exe 6 65 20 1)
    def config_coscoeff():
        dens = make_mvn_density(6, corr=0.5)
        cc = make_cos_coefficients(6, dens.mu, dens.cov, 0.52517, 8.52517)
        res, el, _ = _timed(lambda: cross(cc.fun, [65] * 6, max_rank=20,
                                          accuracy=acc, pivoting=1))
        chk = accchk(res.tt, cc.fun, nlot=2**14)
        line("coscoeff_d6", res, el,
             {"accchk_einf": float(f"{chk['einf']:.3e}"),
              "accchk_rel": float(f"{chk['einf'] / max(chk['ainf'], 1e-300):.3e}")})

    # ---- config 5a: mvn_complex — complex contraction path over config
    # 2's train (the cross is byte-identical to config 2's; only the
    # complex-weights contraction differs, so re-running it would just pay
    # two redundant device crosses)
    def config_mvn_complex(p2, res2, el2):
        w_c = [p2.quad_weights.astype(np.complex128)] * p2.d
        val = complex(tt.contract(res2.tt, w_c))
        dig_c = -np.log10(abs(1 - val / p2.truth)) if val != 0 else float("nan")
        line("mvn_complex_d6", res2, el2,
             {"complex_digits": round(float(dig_c), 2)})

    # ---- quality companion: maxvol pivot replacement past the greedy
    # fixed-rank ceiling on the MVN config (cross(refine_sweeps=2):
    # ~5.9 greedy -> ~7 digits at rank 20 without rank inflation)
    def config_mvn_refined(p2):
        q2 = dict(max_rank=20, accuracy=acc, pivoting=1,
                  quad=[p2.quad_weights] * p2.d, truth=p2.truth)
        res, el, _ = _timed(lambda: cross(p2.fun, [p2.n] * p2.d,
                                          refine_sweeps=2, **q2))
        line("mvn_d6_refined", res, el, {"refine_sweeps": 2})

    guarded("stdnorm_d10", config_stdnorm)
    mvn_out = guarded("mvn_d6", config_mvn)
    guarded("coscoeff_d6", config_coscoeff)
    if mvn_out is not None:
        guarded("mvn_complex_d6", lambda: config_mvn_complex(*mvn_out))
        guarded("mvn_d6_refined", lambda: config_mvn_refined(mvn_out[0]))

    # ---- config 5b: beyond-f64 tier — dd cross of Ising C_4
    def config_dd():
        from ttcross_tpu.apps.ising import make_ising_dd
        from ttcross_tpu.apps.truths import ISING_C_STR
        from ttcross_tpu.cross.engine_dd import cross_dd
        from decimal import Decimal, localcontext

        prob_dd, fun_dd, wh, wl = make_ising_dd(m=4, n=33)
        t0 = time.time()
        rdd = cross_dd(fun_dd, [prob_dd.n] * prob_dd.d, wh, wl,
                       max_rank=16, pivoting=1)
        el = time.time() - t0
        with localcontext() as ctx:
            ctx.prec = 60
            got = Decimal(rdd.value[0]) + Decimal(rdd.value[1])
            rel = abs(1 - got / Decimal(ISING_C_STR[4]))
            dd_digits = float(-rel.log10()) if rel != 0 else 60.0
        _emit({"metric": "ising_c4_dd_tier", "correct_digits": round(dd_digits, 2),
               "n_evals": int(rdd.neval), "wall_time_s": round(el, 3),
               "evals_per_sec": round(rdd.neval / el, 1)})

    # ---- config 5c: quad-double ENGINE tier — stdnorm to ~62 digits
    # (cross/engine_qd.py; pure host numpy, no device work: the ~60-digit
    # point on the multiprecision ladder, between dd ~31 and mpmath 120)
    def config_qd():
        from mpmath import mp as _mp, mpf as _mpf, workdps as _workdps

        from ttcross_tpu.apps.stdnorm import make_stdnorm_qd
        from ttcross_tpu.cross.engine_qd import cross_qd
        from ttcross_tpu.ops.qd import qd_to_mp

        prob_qd, fun_qd, wq = make_stdnorm_qd(d=4, n=201)
        t0 = time.time()
        rqd = cross_qd(fun_qd, [prob_qd.n] * prob_qd.d, max_rank=4, quad=wq)
        el = time.time() - t0
        with _workdps(80):
            got = qd_to_mp(*(np.asarray(e) for e in rqd.value))
            rel = abs(1 - got / _mp.pi ** _mpf(2))     # truth pi^(d/2), d=4
            qd_digits = float(-_mp.log10(rel)) if rel != 0 else 80.0
        _emit({"metric": "stdnorm_d4_qd_engine",
               "correct_digits": round(qd_digits, 2),
               "n_evals": int(rqd.neval), "wall_time_s": round(el, 3),
               "evals_per_sec": round(rqd.neval / el, 1)})

    # ---- config 5d: NATIVE MPFR 120-digit tier (the reference's
    # compiled MPFUN-MPFR role, mpinterface.c:4-85): all-native Ising
    # cross at dps=120.  Host-only — the compiled replacement for the
    # mpmath path.
    def config_mp_native():
        from ttcross_tpu import native as _nat

        if not _nat.mpfr_available():
            _emit({"metric": "ising_c4_mp120_native",
                   "skipped": "libmpfr/g++ unavailable"})
            return
        from ttcross_tpu.cross.engine_mp_native import ising_cross_mp_native

        t0 = time.time()
        r = ising_cross_mp_native("C", m=4, n=65, max_rank=32, dps=120)
        el = time.time() - t0
        _emit({"metric": "ising_c4_mp120_native",
               "correct_digits": round(float(r.digits), 2),
               "n_evals": int(r.neval), "wall_time_s": round(el, 3),
               "evals_per_sec": round(r.neval / el, 1),
               "sweeps": r.sweeps, "dps": 120, "engine": "native-mpfr"})

    # ---- D/E underflow-rescaling regime at d >= 10 (the reference's
    # test path test_crs_ising.f90:135-144; no tabulated truth for m=10,
    # so the line reports convergence [cnv] instead of digits)
    def config_d10():
        p = make_ising("D", m=10, n=17)
        assert p.rescale
        res, el, _ = _timed(lambda: cross(
            p.fun, [p.n] * p.d, max_rank=8, accuracy=acc, pivoting=1,
            quad=[p.quad_weights] * p.d))
        out = {"metric": "ising_d10_rescaled",
               "evals_per_sec": round(res.neval / el, 1),
               "cnv": float(f"{res.errors[-1]:.3e}"),
               "value": float(f"{res.values[-1]:.12e}"),
               "n_evals": int(res.neval), "wall_time_s": round(el, 3),
               "sweeps": res.sweeps, "rescaled": True}
        _emit(out)

    # (the dd/qd/d10 tier runs AFTER the c256/family lines below: its
    # cold compiles are the slowest in the suite and used to starve the
    # strongest device lines out of the soft deadline)

    # ---- config 4: the north star, greedy (reference CLI C 6 64 24 1)
    prob = make_ising("C", m=6, n=64)
    args = dict(max_rank=24, accuracy=acc, pivoting=1,
                quad=[prob.quad_weights] * prob.d, truth=prob.truth)

    def config_greedy():
        res_g, el_g, warm_self = _timed(
            lambda: cross(prob.fun, [prob.n] * prob.d, **args))
        line("ising_c6_greedy", res_g, el_g)
        return (-np.log10(res_g.errors[-1]), warm_self,
                round(res_g.neval / el_g, 1))

    greedy_out = guarded("ising_c6_greedy", config_greedy)
    dig_g, warm_self, eps_g = greedy_out if greedy_out else (None,) * 3

    # (the chunked+rank_caps line is not benched: its unrolled executables'
    # launch overhead exceeded the padded-work saving when last measured.
    # rank_caps stays available as an evaluation-budget feature
    # (cross(rank_caps=...), tested in tests/test_engine.py).)

    # ---- long-chain line: C_256 (d=255) jacobi-rb with a chain spec;
    # compares against the same-host C++ twin when measured.json has the
    # ising_c256 entry.
    def config_c256():
        # red-black two-phase jacobi + chain-structured integrand: rb
        # restores sequential-grade digits at equal rank, the ChainSpec
        # evaluates hunt candidates in O(1) from interface states
        # (cross/chain_eval.py) instead of O(d) per entry.
        p = make_ising("C", m=256, n=17)
        cargs = dict(max_rank=10, accuracy=acc, pivoting=1,
                     quad=[p.quad_weights] * p.d, truth=p.truth,
                     sweep_mode="jacobi-rb", chain=p.chain)
        res, el, _ = _timed(lambda: cross(p.fun, [p.n] * p.d, **cargs))
        extras = {"sweep_ms": round(1e3 * el / max(res.sweeps, 1), 1),
                  "sweep_mode": "jacobi-rb", "chain_eval": True}
        b, src = _baseline_config("ising_c256")
        if b:
            extras["baseline_evals_per_sec"] = b["evals_per_sec"]
            extras["baseline_wall_s"] = b["wall_time_s"]
            extras["baseline_digits"] = b["correct_digits"]
            extras["baseline_source"] = src
            extras["speedup_vs_baseline_wall"] = round(
                b["wall_time_s"] / el, 2)
        line("ising_c256_jacobi", res, el, extras)

    if os.environ.get("TTCROSS_BENCH_C256", "1") not in ("0", "false"):
        guarded("ising_c256_jacobi", config_c256)

    # ---- longest chain: C_1024 (d=1023) rb+chain: the twin's
    # per-evaluation cost grows ~linearly with d (each eval walks the
    # whole chain) while the batched device sweep makes a fixed number of
    # batched calls per sweep.
    def config_c1024():
        p = make_ising("C", m=1024, n=17)
        cargs = dict(max_rank=10, accuracy=acc, pivoting=1,
                     quad=[p.quad_weights] * p.d, truth=p.truth,
                     sweep_mode="jacobi-rb", chain=p.chain)
        res, el, _ = _timed(lambda: cross(p.fun, [p.n] * p.d, **cargs))
        extras = {"sweep_ms": round(1e3 * el / max(res.sweeps, 1), 1),
                  "sweep_mode": "jacobi-rb", "chain_eval": True}
        b, src = _baseline_config("ising_c1024")
        if b:
            extras["baseline_evals_per_sec"] = b["evals_per_sec"]
            extras["baseline_wall_s"] = b["wall_time_s"]
            extras["baseline_digits"] = b["correct_digits"]
            extras["baseline_source"] = src
            extras["speedup_vs_baseline_wall"] = round(
                b["wall_time_s"] / el, 2)
        line("ising_c1024_rb", res, el, extras)

    if os.environ.get("TTCROSS_BENCH_C1024", "1") not in ("0", "false"):
        guarded("ising_c1024_rb", config_c1024)

    # ---- batch family line: L parameterized crosses fused into ONE
    # device program (cross_batch) vs L single runs, steady state.
    def config_family():
        from ttcross_tpu.apps.mvn import make_mvn_family
        from ttcross_tpu.cross import cross_batch

        lanes = 4
        fam = make_mvn_family(d=6, n=65,
                              corrs=np.linspace(0.2, 0.6, lanes))
        # rank 20 = the single-cross MVN baseline config
        bargs = dict(max_rank=20, accuracy=acc, pivoting=1,
                     quad=[fam.quad_weights] * 6, truth=1.0)
        resb, elb, _ = _timed(lambda: cross_batch(
            fam.fun, [fam.n] * 6, fam.params, **bargs))
        resb, elb, _ = _timed(lambda: cross_batch(      # steady (compiled)
            fam.fun, [fam.n] * 6, fam.params, **bargs))
        singles = 0.0
        for lk in range(lanes):
            par = {k: v[lk] for k, v in fam.params.items()}
            fun1 = (lambda p: lambda ind: fam.fun(ind, p))(par)
            _, el1, _ = _timed(lambda: cross(fun1, [fam.n] * 6, **bargs))
            _, el1, _ = _timed(lambda: cross(fun1, [fam.n] * 6, **bargs))
            singles += el1
        worst = min(-np.log10(r.errors[-1]) for r in resb if r.errors)
        out = {"metric": "mvn_family_batch", "lanes": lanes,
               "batch_wall_s": round(elb, 3),
               "singles_wall_s": round(singles, 3),
               "family_speedup": round(singles / elb, 2),
               "worst_lane_digits": round(float(worst), 2),
               "n_evals": int(resb.neval)}
        b, src = _baseline_config("mvn_d6")
        if b:
            # the comparable single-cross baseline at the same rank-20
            # config (corr=0.5 lies inside the lane range)
            out["baseline_digits"] = b["correct_digits"]
            out["baseline_wall_s"] = b["wall_time_s"]
            out["baseline_source"] = src
        _emit(out)

    guarded("mvn_family_batch", config_family)
    # cheap host-only tiers first, then the compile-heavy device tiers
    guarded("ising_c4_mp120_native", config_mp_native)
    guarded("stdnorm_d4_qd_engine", config_qd)
    guarded("ising_c4_dd_tier", config_dd)
    guarded("ising_d10_rescaled", config_d10)

    # ---- HEADLINE (LAST LINE): C_6 crossed at rank 30 on the device,
    # then the skeleton DATA is re-evaluated by the AUTO-DERIVED host twin
    # (the traced integrand re-run on the CPU x64 backend) and the
    # rank-30 -> 24 rounding + value run all-host.  n_evals/padded include
    # the skeleton re-samples.
    def headline():
        res, el, warm_hl = _timed(_run_headline(cross, prob, acc))
        out = _headline_payload(res, el)
        out.update({
            "greedy_digits": (round(float(dig_g), 2)
                              if dig_g is not None else None),
            "greedy_evals_per_sec": eps_g,
            "warmup_time_s": (warm_med if warm_med is not None
                              else (round(warm_self, 3)
                                    if warm_self is not None else None)),
            "warmup_tail_s": warm_tail,
            "warmup_probe_failures": probe_failures,
        })
        _emit(out)

    try:
        headline()
    except Exception as e:
        failed.append("ising_c6_evals_per_sec")
        _emit({"metric": "ising_c6_evals_per_sec", "error": repr(e)[:300]})
    if failed and early_headline is not None:
        # the fresh-process headline measured this config on the card:
        # re-emit it as the parseable tail
        early_headline["stage"] = "fresh_process_reemit"
        _emit(early_headline)
    return 1 if failed else 0


def main_parallel(ndevs):
    """`bench.py --parallel [ndev ...]`: distributed-engine scaling on a
    virtual CPU mesh of 8 host-platform devices (the `mpirun -np N`
    benchmark channel).  The virtual devices share the host's cores, so
    this measures collective/sharding overhead and correctness at scale,
    not speedup; every line says platform "cpu".  Default ndevs: 1 2 4 8."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    d = jax.devices()[0]
    _STAMP.update(platform=d.platform, device_kind=d.device_kind,
                  count=len(jax.devices()))
    import ttcross_tpu  # noqa: F401
    from ttcross_tpu.apps import make_ising
    from ttcross_tpu.cross import cross
    from ttcross_tpu.parallel import cross_parallel
    from ttcross_tpu.parallel.mesh import bond_mesh

    prob = make_ising("C", m=32, n=16)   # d=31: 30 bonds, divisible slabs
    args = dict(max_rank=8, accuracy=500 * 2.2e-16, pivoting=1,
                quad=[prob.quad_weights] * prob.d, truth=prob.truth)
    rows = []
    for ndev in ndevs:
        for rep in range(2):             # second call = steady (cached compile)
            t0 = time.time()
            if ndev == 1:
                res = cross(prob.fun, [prob.n] * prob.d, **args)
            else:
                res = cross_parallel(prob.fun, [prob.n] * prob.d,
                                     mesh=bond_mesh(jax.devices()[:ndev]), **args)
            wall = time.time() - t0
        digits = -np.log10(res.errors[-1]) if res.errors else float("nan")
        rows.append({"ndev": ndev, "wall_s": round(wall, 3),
                     "sweep_ms": round(1e3 * wall / max(res.sweeps, 1), 1),
                     "digits": round(float(digits), 2),
                     "n_evals": int(res.neval), "sweeps": res.sweeps})
        _emit({"metric": "ising_c32_parallel_scaling", **rows[-1]})
    return 0


if __name__ == "__main__":
    _STAMP["nvidia_smi"] = nvidia_smi()
    if len(sys.argv) > 1 and sys.argv[1] == "--warmup-probe":
        sys.exit(warmup_probe())
    if len(sys.argv) > 1 and sys.argv[1] == "--headline-probe":
        sys.exit(headline_probe())
    if len(sys.argv) > 1 and sys.argv[1] == "--parallel":
        nd = [int(x) for x in sys.argv[2:]] or [1, 2, 4, 8]
        sys.exit(main_parallel(nd))
    sys.exit(main())
