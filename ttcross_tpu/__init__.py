"""ttcross-tpu: parallel DMRG-greedy TT-cross interpolation in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
Fortran+MPI library aukeschaap/ttcross (Dolgov & Savostyanov parallel cross
interpolation, arXiv:1903.11554): approximate a black-box d-dimensional
tensor in tensor-train format from O(d n r^2) adaptively chosen samples, then
contract it against rank-1 quadrature tensors to evaluate high-dimensional
integrals.
"""

from . import config  # noqa: F401  (enables x64 on import)
from .tt import TT, from_cores, ones, rank1, zeros  # noqa: F401

__version__ = "0.1.0"
