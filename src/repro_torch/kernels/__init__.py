"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Each kernel source lives in ``csrc/`` and is built by ``_build`` at first
use; importing this package builds and loads nothing."""
from .ops import solve_batched_kernel  # noqa: F401
from .simplex_tile import (  # noqa: F401
    simplex_tile, simplex_tile_plain, smem_bytes, tableau_in_smem,
)
