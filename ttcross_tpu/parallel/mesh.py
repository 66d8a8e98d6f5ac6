"""Bond-slab distribution over a 1-D device mesh.

Maps the reference's MPI work decomposition: `share(first, last, own)`
(default.f90:80-97) block-distributes TT bonds over ranks with the
constraint nproc < d (dmrgg.f90:114-117).  Here the ranks are mesh
devices along a single 'bond' axis and all exchanges are XLA collectives
(NCCL over NVLink on a multi-GPU host).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["share", "bond_mesh", "BOND_AXIS"]

BOND_AXIS = "bond"


def share(nbonds: int, ndev: int) -> np.ndarray:
    """own[k]..own[k+1]-1 = bonds of device k; block distribution with the
    remainder spread over the first devices (share, default.f90:80-97)."""
    if ndev > nbonds:
        raise ValueError(f"more devices ({ndev}) than bonds ({nbonds}); "
                         "the dimension-parallel engine needs ndev <= d-1")
    base, rem = divmod(nbonds, ndev)
    counts = np.full(ndev, base, dtype=np.int32)
    counts[:rem] += 1
    own = np.zeros(ndev + 1, dtype=np.int32)
    own[1:] = np.cumsum(counts)
    return own


def bond_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis 'bond'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (BOND_AXIS,))
