"""Characteristic function and density of the lognormal basket sum.

Maps the complex contraction pipelines of test_crs_chf.f90:153-168 and
test_crs_pdf.f90:136-209: after crossing the MVN pdf once, evaluate the
basket-sum characteristic function

  phi_k = ztt_quad(tt, qq_k),   qq_k[p](x) = w(x) * exp(i omega_k e^x / d),
  omega_k = k pi / (upper - lower)

through the complex weight tensors (the reference's dtt -> ztt promotion +
ztt_quad, dmrgg.f90:1418-1523), then reconstruct the density by the COS
method (cos_approx.f90).  Here a TT is dtype-polymorphic, so "promotion" is
just contracting with complex weights; all 32 contractions are batched into
one einsum chain over the k axis.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..tt import TT
from .cos import cos_approximate

__all__ = ["basket_chf", "basket_chf_pair", "basket_pdf", "basket_pdf_pair"]


def basket_chf_pair(t: TT, nodes, weights, n_terms: int = 32,
                    lower: float = 0.0, upper: float = 300.0):
    """(Re phi_k, Im phi_k) of the basket-sum CHF — the fully TRACED core
    of basket_chf (real/imag pair arithmetic end to end, and
    jax.grad-able: differentiable Greeks of CHF/COS quantities flow
    through a skeleton_tt_fn-built train)."""
    d = t.d
    nodes = np.asarray(nodes)
    weights = np.asarray(weights)
    k = np.arange(n_terms)
    omega = k * np.pi / (upper - lower)                      # (K,)
    phase = omega[:, None] * np.exp(nodes)[None, :] / d      # (K, n)
    wr = jnp.asarray(weights[None, :] * np.cos(phase))
    wi = jnp.asarray(weights[None, :] * np.sin(phase))

    vr = jnp.ones((n_terms, 1, 1), dtype=jnp.float64)
    vi = jnp.zeros((n_terms, 1, 1), dtype=jnp.float64)
    for c in range(d):
        g = t.cores[c]                                        # real cores
        mr = jnp.einsum("inj,kn->kij", g, wr)                # (K, r, r')
        mi = jnp.einsum("inj,kn->kij", g, wi)
        vr, vi = (jnp.einsum("kxi,kij->kxj", vr, mr) - jnp.einsum("kxi,kij->kxj", vi, mi),
                  jnp.einsum("kxi,kij->kxj", vr, mi) + jnp.einsum("kxi,kij->kxj", vi, mr))
    return vr[:, 0, 0], vi[:, 0, 0]


def basket_chf(t: TT, nodes, weights, n_terms: int = 32,
               lower: float = 0.0, upper: float = 300.0) -> np.ndarray:
    """phi_0..phi_{K-1} of the basket sum (1/d) sum_p e^{X_p} under the
    crossed density TT (test_crs_chf.f90:153-168), as host complex values.

    All K contractions run as ONE batched chain: the per-mode weight matrix
    W (K, n) replaces the reference's K sequential ztt_quad collectives.
    Complex arithmetic is explicit real/imag pair math."""
    vr, vi = basket_chf_pair(t, nodes, weights, n_terms, lower, upper)
    return np.asarray(vr) + 1j * np.asarray(vi)


def basket_pdf_pair(t: TT, nodes, weights, xs, n_terms: int = 32,
                    lower: float = 0.0, upper: float = 300.0) -> jnp.ndarray:
    """Fully traced basket-sum density: CHF pair chain + COS
    reconstruction without leaving the device — jax.grad/vmap flow
    through (vega and other density Greeks via skeleton_tt_fn)."""
    from .cos import cos_approximate_pair

    phir, phii = basket_chf_pair(t, nodes, weights, n_terms, lower, upper)
    return cos_approximate_pair(xs, phir, phii, lower, upper)


def basket_pdf(t: TT, nodes, weights, xs, n_terms: int = 32,
               lower: float = 0.0, upper: float = 300.0) -> jnp.ndarray:
    """Density of the basket sum on points xs via CHF + COS reconstruction
    (test_crs_pdf.f90 pipeline)."""
    phis = basket_chf(t, nodes, weights, n_terms, lower, upper)
    return cos_approximate(xs, phis, lower, upper, n_terms)
