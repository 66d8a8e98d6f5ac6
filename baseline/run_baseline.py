#!/usr/bin/env python
"""Measure the same-host reference baseline (BASELINE.md / SURVEY.md §6).

Builds the C++17+OpenMP twin of dtt_dmrgg (ttcross_baseline.cpp), runs the
BASELINE.md configs K times each, and writes baseline/measured.json with
median metrics — the file bench.py reads to compute vs_baseline from a
MEASURED number instead of the stated nominal.

Usage: python baseline/run_baseline.py [K]
       python baseline/run_baseline.py --live ising_c6,ising_c256 [K]

--live runs only the named configs and prints ONE JSON dict to stdout
(no file write): bench.py uses it to re-measure the baseline in the SAME
wall-clock window as the device numbers.  On a shared virtualized host
the same binary's rate swings with the CPU share it gets, so a stale
measured.json can skew vs_baseline; the live same-window number cannot.
"""

import json
import os
import platform
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))   # repo root: ttcross_tpu truths
BIN = os.path.join(HERE, "ttcross_baseline")
SRC = os.path.join(HERE, "ttcross_baseline.cpp")

# (name, argv, json key): the BASELINE.md measurement table
CONFIGS = [
    ("stdnorm_d10", ["stdnorm", "10", "33", "8", "1"], "stdnorm_d10"),
    ("mvn_d6", ["mvn", "6", "65", "20", "1"], "mvn_d6"),
    ("coscoeff_d6", ["coscoeff", "6", "65", "20", "1"], "coscoeff_d6"),
    ("ising_c6", ["ising", "C", "6", "64", "24", "1"], "ising_c6"),
    # long chains: the device jacobi engine's home turf (bench
    # ising_c256_jacobi / ising_c1024_rb; per-eval cost grows ~linearly
    # with d here while the batched device sweep is ~d-independent)
    ("ising_c256", ["ising", "C", "256", "17", "10", "1"], "ising_c256"),
    ("ising_c1024", ["ising", "C", "1024", "17", "10", "1"], "ising_c1024"),
]


def build():
    if (os.path.exists(BIN)
            and os.path.getmtime(BIN) >= os.path.getmtime(SRC)):
        return
    cmd = ["g++", "-O2", "-march=native", "-fopenmp", "-std=c++17",
           "-o", BIN, SRC]
    subprocess.run(cmd, check=True)


def run_one(argv):
    proc = subprocess.run([BIN] + argv, capture_output=True, text=True,
                          timeout=1800, check=True)
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no JSON line from {argv}")


def measure(name, argv, k):
    """Median-of-k metrics for one config (+ Bailey-table digits for the
    long Ising chains the twin has no hard-coded truth for)."""
    runs = [run_one(argv) for _ in range(k)]
    med = statistics.median(r["evals_per_sec"] for r in runs)
    digits = max(r["correct_digits"] for r in runs)
    if argv[0] == "ising" and digits == 0.0:
        # the twin hard-codes only small C_m truths; score the value
        # against the repo's Bailey tables (apps/truths.py) here
        try:
            from ttcross_tpu.apps.truths import ising_truth

            tru = ising_truth(argv[1].upper(), int(argv[2]))
            import math

            digits = round(max(-math.log10(abs(1 - r["value"] / tru))
                               for r in runs), 2)
        except Exception:
            pass
    return {
        "evals_per_sec": round(med, 1),
        "evals_per_sec_max": round(max(r["evals_per_sec"] for r in runs), 1),
        "wall_time_s": statistics.median(r["wall_time_s"] for r in runs),
        "n_evals": runs[0]["n_evals"],
        "correct_digits": digits,
        "threads": runs[0]["threads"],
        "runs": k,
    }


def live_mode(names, k):
    """--live: measure only `names`, print ONE JSON dict, write nothing."""
    build()
    wanted = [c for c in CONFIGS if c[0] in names]
    out = {key: measure(name, argv, k) for name, argv, key in wanted}
    out["measured_at"] = time.strftime("%Y-%m-%d %H:%M:%S")
    print(json.dumps(out), flush=True)


def main():
    argv = sys.argv[1:]
    if argv and argv[0] == "--live":
        names = argv[1].split(",")
        live_mode(names, int(argv[2]) if len(argv) > 2 else 3)
        return
    k = int(argv[0]) if argv else 5
    build()
    out = {
        "host": {
            "cpu": platform.processor() or platform.machine(),
            "nproc": os.cpu_count(),
            "omp_threads": int(os.environ.get("OMP_NUM_THREADS",
                                              os.cpu_count())),
            "measured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
            "compiler": subprocess.run(
                ["g++", "--version"], capture_output=True,
                text=True).stdout.splitlines()[0],
        },
        "note": ("Same-host C++17+OpenMP twin of the reference dtt_dmrgg "
                 "(dmrgg.f90); median of %d runs per config. Re-run "
                 "baseline/run_baseline.py after a host change." % k),
    }
    for name, argv, key in CONFIGS:
        out[key] = measure(name, argv, k)
        print(json.dumps({"config": name, **out[key]}), flush=True)
    path = os.path.join(HERE, "measured.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
