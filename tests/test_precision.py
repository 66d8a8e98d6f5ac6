"""Every f32 contraction on the engine's main path states its precision.

On GPUs XLA may run an f32 dot_general at DEFAULT precision in TF32
(~11 significant bits), which would round lottery weights and residual
scores.  These tests walk the traced programs of the sequential sweep,
the rank-capped sweep and the red-black jacobi sweep with a chain spec,
and fail on any f32 dot_general left at default precision."""

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest

from ttcross_tpu.apps import make_ising
from ttcross_tpu.config import precision_thresholds
from ttcross_tpu.cross import make_engine
from ttcross_tpu.cross.engine import CrossConfig


def _subjaxprs(params):
    for v in params.values():
        for x in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(x, jax.extend.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jax.extend.core.Jaxpr):
                yield x


def default_precision_f32_dots(jaxpr):
    """dot_general equations with an f32 operand and no stated precision,
    found anywhere in the jaxpr (loop bodies, branches, nested jits)."""
    bad = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            f32 = any(v.aval.dtype == jnp.float32 for v in eqn.invars)
            prec = eqn.params.get("precision")
            unstated = prec is None or all(
                p in (None, jax.lax.Precision.DEFAULT) for p in prec)
            if f32 and unstated:
                bad.append(str(eqn)[:160])
        for sub in _subjaxprs(eqn.params):
            bad += default_precision_f32_dots(sub)
    return bad


def _engine_jaxpr(m, n, R, **cfg_kw):
    p = make_ising("C", m=m, n=n)
    se, sp = precision_thresholds()
    chain = cfg_kw.pop("chain", None)
    cfg = CrossConfig(d=p.d, n=(p.n,) * p.d, N=p.n, R=R, piv=1,
                      small_element=se, small_pivot=sp, **cfg_kw)
    kit = make_engine(p.fun, cfg, chain=p.chain if chain else None)
    full_fn = kit.make_full_fn(3, True, 500 * 2.2e-16)
    w = jnp.zeros((p.d, p.n))
    return jax.make_jaxpr(full_fn)(jax.random.PRNGKey(0), w).jaxpr


@pytest.mark.parametrize("case", ["c6_sequential", "c6_rank_caps",
                                  "c32_jacobi_rb_chain", "unpinned_control"])
def test_no_f32_dot_at_default_precision(case):
    if case == "c6_sequential":
        jaxpr = _engine_jaxpr(6, 64, 24)
    elif case == "c6_rank_caps":
        jaxpr = _engine_jaxpr(6, 64, 24, wlot=True, caps=(12, 24, 24, 12))
    elif case == "c32_jacobi_rb_chain":
        jaxpr = _engine_jaxpr(32, 17, 8, jacobi=True, rb=True, chain=True)
    else:
        # the walk itself must see through jit and loop bodies
        def f(a, b):
            return jax.lax.fori_loop(0, 2, lambda i, x: jax.jit(jnp.dot)(x, b), a)

        a = np.ones((4, 4), np.float32)
        jaxpr = jax.make_jaxpr(f)(a, a).jaxpr
        assert len(default_precision_f32_dots(jaxpr)) == 1
        return
    bad = default_precision_f32_dots(jaxpr)
    assert not bad, "\n".join(bad)
