"""Equicorrelated multivariate-normal pdf integrand.

Maps mvn_pdf.f90: the lognormal-model covariance (sigma = 0.4, corr = 0.5,
X0 = log 100, mvn_init at mvn_pdf.f90:15-60) and the Mahalanobis-exponent
pdf (mvn_pdf.f90:63-83).  Instead of module-global state and LAPACK
dgetrf/dgetri, the problem is an immutable bundle with the inverse
covariance precomputed on host; the pdf itself is a batched einsum.

Used by the MVN probability driver (test_crs_mvn.f90: mass = 1 on the
cumulant box [0.52517, 8.52517]) and by the CHF / pdf / COS pipelines.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..ops.quadrature import lgwt, map_to_interval

__all__ = ["MvnDensity", "make_mvn_density", "MvnProblem", "make_mvn",
           "MvnFamily", "make_mvn_family"]

# Cumulant-derived integration box with L = 10 (test_crs_mvn.f90:81-83)
MVN_BOX = (0.525170, 8.525170)


@dataclass(frozen=True)
class MvnDensity:
    """N(mu, cov) density with precomputed inverse covariance."""

    mu: np.ndarray
    cov: np.ndarray
    inv_cov: np.ndarray
    det_cov: float

    @property
    def d(self) -> int:
        return self.mu.shape[0]

    def pdf(self, x):
        """Batched pdf: x (B, d) -> (B,)."""
        x = jnp.asarray(x)
        diff = x - jnp.asarray(self.mu)
        expo = jnp.einsum("bi,ij,bj->b", diff, jnp.asarray(self.inv_cov), diff)
        norm = np.sqrt((2.0 * np.pi) ** self.d * self.det_cov)
        return jnp.exp(-0.5 * expo) / norm


def make_mvn_density(d: int, r: float = 0.0, T: float = 1.0,
                     sigma: float = 0.4, corr: float = 0.5) -> MvnDensity:
    """Equicorrelated lognormal-model density (mvn_init, mvn_pdf.f90:15-60)."""
    X0 = np.log(100.0)
    mu = np.full(d, X0 + (r - 0.5 * sigma**2) * T)
    cov = np.full((d, d), sigma * corr * sigma * T)
    np.fill_diagonal(cov, sigma * sigma * T)
    inv_cov = np.linalg.inv(cov)
    det_cov = float(np.linalg.det(cov))
    return MvnDensity(mu=mu, cov=cov, inv_cov=inv_cov, det_cov=det_cov)


@dataclass(frozen=True)
class MvnProblem:
    d: int
    n: int
    nodes: np.ndarray
    quad_weights: np.ndarray
    density: MvnDensity
    truth: float

    def fun(self, ind):
        from ..ops.dense import table_lookup

        x = table_lookup(self.nodes, ind)
        return self.density.pdf(x)


def make_mvn(d: int = 6, n: int = 65, r: float = 0.0, T: float = 1.0,
             sigma: float = 0.4, corr: float = 0.5) -> MvnProblem:
    if n % 2 == 0:
        n += 1
    a, b = MVN_BOX
    x, w = lgwt(n)
    x, w = map_to_interval(x, w, a, b)
    return MvnProblem(d=d, n=n, nodes=x, quad_weights=w,
                      density=make_mvn_density(d, r, T, sigma, corr), truth=1.0)


@dataclass(frozen=True)
class MvnFamily:
    """A correlation FAMILY of MVN problems for cross_batch: params carries
    per-lane (mu, inv_cov, norm) with a leading lane axis; `fun(ind, par)`
    is the parameterized integrand (the vectorized form of the reference's
    `par` callback argument, dmrgg.f90:18 / mvn_pdf.f90's module globals)."""

    d: int
    n: int
    nodes: np.ndarray
    quad_weights: np.ndarray
    corrs: tuple
    params: dict
    truth: float = 1.0       # each lane integrates its pdf mass

    def fun(self, ind, par):
        from ..ops.dense import table_lookup

        x = table_lookup(self.nodes, ind)
        diff = x - par["mu"]
        expo = jnp.einsum("bi,ij,bj->b", diff, par["inv_cov"], diff)
        return jnp.exp(-0.5 * expo) / par["norm"]


def make_mvn_family(d: int = 6, n: int = 65, corrs=(0.3, 0.5, 0.7),
                    r: float = 0.0, T: float = 1.0,
                    sigma: float = 0.4) -> MvnFamily:
    """Equicorrelated MVN problems across correlation values, one cross
    lane per corr (every lane's mass is 1 on the shared cumulant box)."""
    if n % 2 == 0:
        n += 1
    a, b = MVN_BOX
    x, w = lgwt(n)
    x, w = map_to_interval(x, w, a, b)
    dens = [make_mvn_density(d, r, T, sigma, float(c)) for c in corrs]
    params = {
        "mu": jnp.asarray(np.stack([dn.mu for dn in dens])),
        "inv_cov": jnp.asarray(np.stack([dn.inv_cov for dn in dens])),
        "norm": jnp.asarray(np.array(
            [np.sqrt((2.0 * np.pi) ** d * dn.det_cov) for dn in dens])),
    }
    return MvnFamily(d=d, n=n, nodes=x, quad_weights=w,
                     corrs=tuple(float(c) for c in corrs), params=params)
