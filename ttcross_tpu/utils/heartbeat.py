"""Compile/warmup heartbeat.

First-run engine compiles can take a minute or more with zero output
(long chains, many unrolled bond visits).  The reference never compiles
at runtime so it never needed this; here every blocking first call is
wrapped in a heartbeat that starts printing only after `first_delay`
seconds — steady cache-hit runs stay silent — and then reports elapsed
time every `interval` seconds so a user can tell a long compile from a
hang.

Disable with TTCROSS_HEARTBEAT=0.
"""

from __future__ import annotations

import os
import sys
import threading
import time

__all__ = ["heartbeat"]


def _enabled() -> bool:
    return os.environ.get("TTCROSS_HEARTBEAT", "1") not in ("0", "false")


class heartbeat:
    """Context manager: print a progress line while the body blocks.

    with heartbeat("engine compile (C_6 r24)"):
        full_fn(key, w)          # may block minutes on first run
    """

    def __init__(self, label: str, first_delay: float = 10.0,
                 interval: float = 30.0, stream=None):
        self.label = label
        self.first_delay = first_delay
        self.interval = interval
        self.stream = stream if stream is not None else sys.stderr
        self._stop = threading.Event()
        self._thread = None
        self._printed = False

    def _run(self, t0: float):
        if self._stop.wait(self.first_delay):
            return
        while True:
            el = time.perf_counter() - t0
            print(f"[ttcross] {self.label}: still working after {el:.0f}s "
                  "(first-run compiles can take minutes; executables are "
                  "cached for subsequent runs)",
                  file=self.stream, flush=True)
            self._printed = True
            if self._stop.wait(self.interval):
                return

    def __enter__(self):
        if _enabled():
            self._thread = threading.Thread(
                target=self._run, args=(time.perf_counter(),), daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            if self._printed and exc[0] is None:
                print(f"[ttcross] {self.label}: done", file=self.stream,
                      flush=True)
        return False
