"""Numerical guards: NaN detection and structural checks.

Maps nan.f90 (portable NaN detection used to catch broken LAPACK,
ort.f90:58) and the allocation-size audit dtt_memchk (tt.f90:836-877).
On the device these are debug utilities; inside jit use `jax.debug` or checkify.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..tt.types import TT

__all__ = ["has_nan", "assert_finite", "tt_check"]


def has_nan(*arrays) -> bool:
    """True if any array contains NaN (nan.f90:8-82)."""
    return any(bool(jnp.any(jnp.isnan(jnp.asarray(a).real))) for a in arrays)


def assert_finite(x, what: str = "array"):
    x = jnp.asarray(x)
    if not bool(jnp.all(jnp.isfinite(x.real))):
        raise FloatingPointError(f"{what} contains non-finite values")
    return x


def tt_check(t: TT) -> None:
    """Structural + numerical validation (ready + memchk analogue,
    tt.f90:836-877, 1306-1345)."""
    if not t.ready():
        raise ValueError(f"inconsistent TT core shapes: {[c.shape for c in t.cores]}")
    for c, g in enumerate(t.cores):
        if not bool(jnp.all(jnp.isfinite(jnp.asarray(g).real))):
            raise FloatingPointError(f"TT core {c} contains non-finite values")
