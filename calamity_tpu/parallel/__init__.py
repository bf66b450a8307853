"""Multi-device scaling: mesh construction, shardings, batched fits.

Replaces the reference's single-GPU device placement (calibration.py:
1741-1753) with jax.sharding over device meshes; collectives are inserted by
XLA from the sharding layout (SURVEY.md §2.8).
"""

from .batched import BatchedFitResult, batched_chunk_losses, batched_fit_core
from .mesh import fit_shardings, make_mesh, shard_chunk

__all__ = [
    "make_mesh",
    "fit_shardings",
    "shard_chunk",
    "batched_fit_core",
    "batched_chunk_losses",
    "BatchedFitResult",
]
