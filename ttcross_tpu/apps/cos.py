"""Fang-Oosterlee COS method pipeline: sign vectors, Gaussian characteristic
function, COS coefficient tensors, and density reconstruction.

Maps s_vectors.f90 (generate_s_vectors), funcs.f90 (gaussian_chf_nd),
coefficients.f90 (calc_coefficient), and cos_approx.f90 (cos_approximate /
cos_approximate_array).  The reference builds these on module-global state
one entry at a time; here everything is a pure batched function closed over
an immutable problem bundle — the coefficient tensor entry evaluation is a
(B, 2^{d-1}, d) vectorized sweep suitable for the cross engine's batched
integrand protocol.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

__all__ = [
    "s_vectors",
    "gaussian_chf",
    "gaussian_chf_parts",
    "CosCoefficients",
    "make_cos_coefficients",
    "cos_approximate",
    "cos_approximate_pair",
]


def s_vectors(d: int) -> np.ndarray:
    """All 2^(d-1) sign vectors with first component +1, shape (2^(d-1), d)
    (generate_s_vectors, s_vectors.f90:7-29)."""
    k = np.arange(2 ** (d - 1))
    bits = (k[:, None] >> np.arange(d - 1)[None, :]) & 1
    s = np.concatenate([np.ones((k.size, 1), dtype=np.int64), 1 - 2 * bits], axis=1)
    return s


def gaussian_chf_parts(omega, mu, sigma):
    """Real/imag parts of phi(omega) = exp(i omega.mu - omega^T Sigma omega/2)
    as (magnitude * cos, magnitude * sin) — real pair arithmetic (a form
    shaped for the first target, without complex128)."""
    omega = jnp.asarray(omega)
    mu = jnp.asarray(mu)
    sigma = jnp.asarray(sigma)
    dot_mu = jnp.tensordot(omega, mu, axes=[[-1], [0]])
    quad = jnp.einsum("...i,ij,...j->...", omega, sigma, omega)
    mag = jnp.exp(-0.5 * quad)
    return mag * jnp.cos(dot_mu), mag * jnp.sin(dot_mu)


def gaussian_chf(omega, mu, sigma):
    """phi(omega) = exp(i omega.mu - 1/2 omega^T Sigma omega), batched over
    leading axes of omega (gaussian_chf_nd, funcs.f90:8-26).  Complex-dtype
    convenience wrapper; device code should use gaussian_chf_parts."""
    re, im = gaussian_chf_parts(omega, mu, sigma)
    return re + 1j * im


@dataclass(frozen=True)
class CosCoefficients:
    """COS coefficient tensor of a Gaussian: the black-box integrand crossed
    by test_crs_coscoeff (calc_coefficient, coefficients.f90:33-65)."""

    d: int
    mu: np.ndarray
    sigma: np.ndarray
    lower: float
    upper: float

    def fun(self, ind):
        """Batched entry evaluation: ind (B, d) int -> (B,) f64.

        f(ind) = 2/(b-a)^d  sum_s  Re[ e^{-i a sum_j t_j} phi(t) ],
        with t_j = pi s_j (ind_j) / (b - a)  (0-based ind; the reference's
        ind_j - 1 with 1-based indices, coefficients.f90:52-57).

        Computed in real pair arithmetic:
        Re[e^{i(t.mu - a sum t)}] e^{-q/2} = e^{-q/2} cos(t.mu - a sum t)."""
        ind = jnp.asarray(ind)
        sv = jnp.asarray(s_vectors(self.d), dtype=jnp.float64)  # (S, d)
        one_over = 1.0 / (self.upper - self.lower)
        t = (np.pi * one_over) * sv[None, :, :] * ind[:, None, :].astype(jnp.float64)
        dot_mu = jnp.tensordot(t, jnp.asarray(self.mu), axes=[[-1], [0]])   # (B, S)
        quad = jnp.einsum("bsi,ij,bsj->bs", t, jnp.asarray(self.sigma), t)
        phase = dot_mu - self.lower * jnp.sum(t, axis=-1)
        real_sum = jnp.sum(jnp.exp(-0.5 * quad) * jnp.cos(phase), axis=-1)
        return 2.0 * one_over**self.d * real_sum


def make_cos_coefficients(d: int, mu, sigma, lower: float, upper: float) -> CosCoefficients:
    return CosCoefficients(d=d, mu=np.asarray(mu, dtype=np.float64),
                           sigma=np.asarray(sigma, dtype=np.float64),
                           lower=float(lower), upper=float(upper))


def cos_approximate_pair(xs, phir, phii, lower: float, upper: float):
    """Traced COS reconstruction from a CHF real/imag PAIR (phir, phii)
    (K,) — the jax.grad-able twin of cos_approximate (which converts to
    host numpy complex); K is the static pair length."""
    xs = jnp.atleast_1d(jnp.asarray(xs, dtype=jnp.float64))
    K = phir.shape[0]
    omega = jnp.asarray(np.arange(K, dtype=np.float64) * np.pi / (upper - lower))
    coeff = 2.0 / (upper - lower) * (phir * jnp.cos(omega * lower)
                                     + phii * jnp.sin(omega * lower))
    coeff = coeff * jnp.where(jnp.arange(K) == 0, 0.5, 1.0)
    return jnp.cos(omega[None, :] * (xs[:, None] - lower)) @ coeff


def cos_approximate(xs, phis, lower: float, upper: float, n_terms: int | None = None):
    """COS density reconstruction from characteristic-function values,
    vectorized over xs (cos_approximate_array, cos_approx.f90:88-127):

      pdf(x) = sum_{k=0}^{K-1} c_k cos(omega_k (x - a)),
      c_k = 2/(b-a) Re[phi_k e^{-i omega_k a}],  c_0 halved.
    """
    xs = jnp.atleast_1d(jnp.asarray(xs, dtype=jnp.float64))
    phis = np.asarray(phis)
    K = phis.shape[0] if n_terms is None else n_terms
    if K > phis.shape[0]:
        raise ValueError("n_terms exceeds the number of CHF values")
    k = np.arange(K, dtype=np.float64)
    omega = k * np.pi / (upper - lower)
    # Re[phi e^{-i omega a}] in real pair arithmetic
    coeff = 2.0 / (upper - lower) * (phis[:K].real * np.cos(omega * lower)
                                     + phis[:K].imag * np.sin(omega * lower))
    coeff[0] *= 0.5
    return jnp.cos(jnp.asarray(omega)[None, :] * (xs[:, None] - lower)) @ jnp.asarray(coeff)
