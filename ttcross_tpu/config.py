"""Global configuration for ttcross-tpu.

The reference library (aukeschaap/ttcross) is a double-precision Fortran code
(dmrgg.f90:62-84 dispatches on storage_size(1.d0)).  We make float64 the
default compute dtype and enable JAX x64 at import time; opt out with
TTCROSS_NO_X64=1 to run a float32 tier (the analogue of compiling the
reference with -fdefault-real-4).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

if not os.environ.get("TTCROSS_NO_X64"):
    jax.config.update("jax_enable_x64", True)

# TTCROSS_PLATFORM=cpu[:N] forces the CPU backend, optionally with N
# virtual devices for mesh runs (`TTCROSS_PLATFORM=cpu:8 python
# drivers/...`).  Must run before the backend initializes; if some earlier
# compute already initialized it, we clear and re-select (safe: this
# module is imported at package import time, before user arrays exist).
_plat = os.environ.get("TTCROSS_PLATFORM", "").lower()
if _plat:
    name, _, ndev = _plat.partition(":")
    if name == "cpu" and ndev:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count={int(ndev)}")
    jax.config.update("jax_platforms", name)
    from jax._src import xla_bridge as _xb

    if _xb.backends_are_initialized():
        _xb._clear_backends()


def _compile_cache_dir() -> str | None:
    """Where this package puts JAX's persistent compilation cache.

    None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself)
    or when the CPU backend is selected: XLA:CPU executables reloaded by
    another process, possibly on another host CPU, can fault on load.
    Otherwise ``<checkout>/.jax_cache`` — a fixed path, since the path is
    part of the cache key."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    selected = (jax.config.jax_platforms or "").lower()
    if "cpu" in os.environ.get("JAX_PLATFORMS", "").lower() or "cpu" in selected:
        return None
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        ".jax_cache")


_cache_dir = _compile_cache_dir()
if _cache_dir:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def default_dtype() -> jnp.dtype:
    """Default real dtype (f64 unless x64 is disabled)."""
    return jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32


def default_complex_dtype() -> jnp.dtype:
    return jnp.complex128 if jax.config.read("jax_enable_x64") else jnp.complex64


def eps(dtype=None) -> float:
    """Machine epsilon of the given (or default) real dtype."""
    return float(jnp.finfo(dtype or default_dtype()).eps)


def precision_thresholds(dtype=None) -> tuple[float, float]:
    """(small_element, small_pivot) acceptance thresholds per dtype.

    Mirrors the reference's precision dispatch (dmrgg.f90:62-84):
      real*4  -> (5 eps, 1e-3);  real*8 -> (10 eps, 1e-5);
      real*16 -> (50 eps, 1e-7).
    """
    dt = jnp.dtype(dtype or default_dtype())
    e = float(jnp.finfo(dt).eps)
    if dt.itemsize <= 4:
        return 5.0 * e, 1.0e-3
    if dt.itemsize == 8:
        return 10.0 * e, 1.0e-5
    return 50.0 * e, 1.0e-7
