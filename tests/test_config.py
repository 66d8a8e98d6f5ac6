"""Compile-cache placement (ttcross_tpu/config.py), checked in fresh
interpreters: JAX_COMPILATION_CACHE_DIR is honoured and no other cache
is set; without it the cache sits at <checkout>/.jax_cache; the CPU
backend gets none."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

PROBE = """
import sys, pathlib
sys.path.insert(0, {root!r})
import ttcross_tpu, jax, jax.numpy as jnp
print("CACHE", jax.config.jax_compilation_cache_dir)
if {compile}:
    jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(3)).block_until_ready()
"""


def _run(env_over, compile_=False):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                        "TTCROSS_PLATFORM")}
    env.update(env_over)
    code = PROBE.format(root=str(ROOT), compile=compile_)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [s for s in out.stdout.splitlines() if s.startswith("CACHE ")][-1]
    return line.split(" ", 1)[1]


@pytest.mark.parametrize("case", ["env_var", "default", "cpu_selected"])
def test_compile_cache_placement(tmp_path, case):
    if case == "env_var":
        cache = tmp_path / "jcc"
        got = _run({"JAX_COMPILATION_CACHE_DIR": str(cache),
                    "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
                    "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0"},
                   compile_=True)
        assert got == str(cache)
        assert any(cache.iterdir()), "the compile wrote no cache entry"
    elif case == "default":
        assert _run({}) == str(ROOT / ".jax_cache")
    else:
        assert _run({"JAX_PLATFORMS": "cpu"}) == "None"
