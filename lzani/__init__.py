"""LZ-ANI in JAX: rapid all-vs-all average nucleotide identity.

A ground-up reimplementation of the capabilities of refresh-bio/LZ-ANI
(the reference implementation): a JAX device engine for the
pair-parse compute path (compiled by XLA for the GPU), a native C++ host
engine (CPU backend + oracle), a hybrid scheduler that runs both on one
row queue, and jax.distributed scale-out over processes.
"""

__version__ = "0.1.0"
VERSION_STRING = "lz-ani-jax 0.1.0"

from .params import Params  # noqa: F401
from .matcher import Matcher  # noqa: F401
