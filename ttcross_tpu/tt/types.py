"""Tensor-train container.

JAX re-design of the reference `dtt`/`ztt` types (tt.f90:18-52): instead
of Fortran pointer-wrapped ragged cores, a TT is an immutable JAX pytree whose
cores are a tuple of arrays with static shapes ``(r[c], n[c], r[c+1])``.  One
container serves every dtype tier (f32 / f64 / complex64 / complex128), which
replaces the reference's dtt/ztt/mptt type triplication.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["TT", "ones", "zeros", "from_cores", "rank1"]


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class TT:
    """Tensor train: ``A(i_0..i_{d-1}) = G_0[:,i_0,:] @ ... @ G_{d-1}[:,i_{d-1},:]``.

    cores[c] has shape (r[c], n[c], r[c+1]); boundary ranks r[0] = r[d] = 1.
    """

    cores: tuple[jax.Array, ...]

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return self.cores, None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(tuple(children))

    # -- structural properties --------------------------------------------
    @property
    def d(self) -> int:
        return len(self.cores)

    @property
    def n(self) -> tuple[int, ...]:
        return tuple(c.shape[1] for c in self.cores)

    @property
    def r(self) -> tuple[int, ...]:
        """Bond ranks, length d+1 (r[0] = r[d] = 1 for a proper train)."""
        return tuple(c.shape[0] for c in self.cores) + (self.cores[-1].shape[2],)

    @property
    def dtype(self):
        return self.cores[0].dtype

    def ready(self) -> bool:
        """Structural validation (analogue of dtt_ready, tt.f90:1306-1345)."""
        if self.d == 0:
            return False
        r = self.r
        if r[0] != 1 or r[-1] != 1:
            return False
        for c in range(self.d):
            rc, _, rn = self.cores[c].shape
            if rc != r[c] or rn != r[c + 1]:
                return False
        return True

    def erank(self) -> float:
        """Effective rank: solves a*re^2 + b*re = mem for re (tt.f90:1228-1263)."""
        d = self.d
        if d <= 1:
            return 0.0
        n, r = self.n, self.r
        mem = sum(r[c] * n[c] * r[c + 1] for c in range(d))
        b = r[0] * n[0] + n[d - 1] * r[d]
        if d == 2:
            return mem / b
        a = sum(n[1 : d - 1])
        return (math.sqrt(b * b + 4.0 * a * mem) - b) / (2.0 * a)

    def mem(self) -> int:
        """Total number of stored core entries (dtt_mem, tt.f90:1266-1281)."""
        return sum(int(np.prod(c.shape)) for c in self.cores)

    def astype(self, dtype) -> "TT":
        return TT(tuple(c.astype(dtype) for c in self.cores))

    def __repr__(self) -> str:  # compact, like dtt_say (tt.f90:1200-1225)
        return f"TT(d={self.d}, n={list(self.n)}, r={list(self.r)}, dtype={self.dtype})"


def from_cores(cores: Sequence[jax.Array]) -> TT:
    t = TT(tuple(jnp.asarray(c) for c in cores))
    if not t.ready():
        raise ValueError(f"inconsistent core shapes: {[c.shape for c in t.cores]}")
    return t


def ones(n: Sequence[int], dtype=None) -> TT:
    """Rank-1 all-ones train (dtt_ones, tt.f90)."""
    from ..config import default_dtype

    dt = dtype or default_dtype()
    return TT(tuple(jnp.ones((1, ni, 1), dtype=dt) for ni in n))


def zeros(n: Sequence[int], dtype=None) -> TT:
    from ..config import default_dtype

    dt = dtype or default_dtype()
    return TT(tuple(jnp.zeros((1, ni, 1), dtype=dt) for ni in n))


def rank1(vectors: Sequence[jax.Array]) -> TT:
    """Rank-1 train from per-mode vectors (e.g. quadrature weight tensors,
    test_crs_ising.f90:130-131)."""
    return TT(tuple(jnp.asarray(v).reshape(1, -1, 1) for v in vectors))
