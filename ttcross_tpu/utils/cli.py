"""Positional CLI argument parsing with defaults.

Maps readarg (default.f90:40-78): drivers take positional args and fall
back to defaults, e.g. `crs_ising.py C 6 64 24 1`.
"""

from __future__ import annotations

import sys

__all__ = ["readarg", "print_config"]


def readarg(pos: int, default, cast=None):
    """Positional CLI argument `pos` (1-based) with a default; the cast is
    inferred from the default's type unless given."""
    if cast is None:
        cast = type(default)
    if len(sys.argv) > pos:
        return cast(sys.argv[pos])
    return default


def maybe_accchk(res, fun, nlot: int = 1 << 14) -> None:
    """Randomized accuracy verification after a driver run, enabled with
    TTCROSS_ACCCHK=1 (the dtt_accchk pattern the reference's demo used,
    main.f90:50)."""
    import os

    if os.environ.get("TTCROSS_ACCCHK", "").lower() in ("", "0", "false", "no", "off"):
        return
    from ..cross.accchk import accchk

    chk = accchk(res.tt, fun, nlot=nlot)
    print(f"accchk: einf {chk['einf']:.3e} efro {chk['efro']:.3e} "
          f"ainf {chk['ainf']:.3e} afro {chk['afro']:.3e} "
          f"worst {chk['worst_index']}")


def _device_banner():
    """Describe the jax backend WITHOUT forcing its initialization.

    jax.devices() initializes the backend on first call, which opens
    (and reserves memory on) the accelerator.  A banner must never be the
    first device touch — a host-only driver (the mpmath/qd tiers) would
    take a card it never uses.  Report live devices only if some earlier
    compute already initialized the backend."""
    import jax

    try:
        from jax._src import xla_bridge as xb

        initialized = bool(xb._backends)
    except Exception:  # private API moved: fall back to the direct query
        initialized = True
    if not initialized:
        return "(backend not initialized; first compute selects it)", "-"
    devs = jax.devices()
    return str(devs[0]), len(devs)


def print_config(**kv) -> None:
    """Driver banner (pattern of test_crs_*.f90 config summaries)."""
    for k, v in kv.items():
        print(f"   {k:<10s}: {v}")
    dev, ndev = _device_banner()
    print(f"   {'device':<10s}: {dev}")
    print(f"   {'n devices':<10s}: {ndev}")
