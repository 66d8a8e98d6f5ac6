#!/usr/bin/env python
"""Parameter sensitivities (Greeks) of a cross integral via jax.grad:
`crs_greeks.py D N RANK [NRHO]`

Crosses the equicorrelated MVN mass once at rho = 0.5, freezes the
pivot skeleton, then differentiates the skeleton interpolant's value in
the correlation parameter with jax.grad and sweeps a whole rho family
with jax.vmap at fixed skeleton — no extra pivot hunts, one batched
integrand re-evaluation per parameter point.  The reference can only
re-run whole crosses per parameter value (its `par` argument,
dmrgg.f90:18, is evaluate-only); frozen-skeleton AD is a capability the
JAX re-design adds.  The printed sanity column is a central finite
difference of the skeleton value (should match grad to ~1e-6)."""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp
import numpy as np

import ttcross_tpu  # noqa: F401
from ttcross_tpu.apps.mvn import MVN_BOX
from ttcross_tpu.cross import cross, extract_skeleton, skeleton_value_fn
from ttcross_tpu.ops.quadrature import lgwt, map_to_interval
from ttcross_tpu.utils import print_config, readarg


def mvn_rho_fun(nodes, d, sigma=0.4, T=1.0):
    """MVN pdf with rho TRACED: Sherman-Morrison closed-form inverse of
    cov = s2 ((1-rho) I + rho 11^T) so AD flows through the integrand."""
    s2 = sigma * sigma * T
    mu = jnp.full((d,), np.log(100.0) - 0.5 * sigma * sigma * T)

    def fun(ind, rho):
        x = jnp.take(nodes, ind, axis=0)
        diff = x - mu
        denom = 1.0 + (d - 1.0) * rho
        q = (jnp.sum(diff * diff, axis=1)
             - rho / denom * jnp.sum(diff, axis=1) ** 2) / (s2 * (1.0 - rho))
        det = (s2 ** d) * ((1.0 - rho) ** (d - 1)) * denom
        return jnp.exp(-0.5 * q) / jnp.sqrt((2.0 * jnp.pi) ** d * det)

    return fun


def main():
    d = readarg(1, 6)
    n = readarg(2, 65)
    rank = readarg(3, 14)
    nrho = readarg(4, 5)
    rho0 = 0.5

    a, b = MVN_BOX
    x, w = lgwt(n)
    x, w = map_to_interval(x, w, a, b)
    x, w = jnp.asarray(x), jnp.asarray(w)
    fun = mvn_rho_fun(x, d)
    print_config(dimension=d, quadratur=n, TT_ranks=rank, rho0=rho0)

    acc = 500 * np.finfo(np.float64).eps
    res = cross(lambda i: fun(i, rho0), [n] * d, max_rank=rank,
                accuracy=acc, pivoting=1, quad=[np.asarray(w)] * d,
                truth=1.0, key=5, verbose=True, return_state=True)
    skel = extract_skeleton(res, [n] * d)
    vfn = skeleton_value_fn(fun, skel, weights=[w] * d)

    v0 = float(vfn(jnp.float64(rho0)))
    g = float(jax.grad(vfn)(jnp.float64(rho0)))
    h = 1e-5
    fd = (float(vfn(jnp.float64(rho0 + h)))
          - float(vfn(jnp.float64(rho0 - h)))) / (2 * h)
    print(f"mass({rho0}) = {v0:.12e}   (cross value {res.values[-1]:.12e}, "
          f"{skel.n_samples} skeleton samples)")
    print(f"d mass / d rho = {g:.10e}   central-FD check {fd:.10e}")

    rhos = jnp.linspace(0.3, 0.7, nrho)
    masses = jax.vmap(vfn)(rhos)
    greeks = jax.vmap(jax.grad(vfn))(rhos)
    print("frozen-skeleton rho sweep (vmap, one device call):")
    for r, m, gg in zip(np.asarray(rhos), np.asarray(masses),
                        np.asarray(greeks)):
        print(f"  rho {r:.3f}: mass {m:.10e}  d/drho {gg:+.6e}")


if __name__ == "__main__":
    main()
