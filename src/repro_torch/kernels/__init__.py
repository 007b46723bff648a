"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Each kernel source lives in ``csrc/`` and is built by ``_build`` at first
use; importing this package builds and loads nothing."""
from .hyperbox_kernel import hyperbox_tile, hyperbox_tile_plain  # noqa: F401
from .ops import (  # noqa: F401
    KernelBackend, PdhgKernelBackend, RevisedKernelBackend,
    solve_batched_kernel, solve_hyperbox_kernel,
)
from .pdhg_tile import (  # noqa: F401
    pdhg_segment_tile, pdhg_segment_tile_plain, pdhg_tile, pdhg_tile_plain,
)
from .revised_tile import (  # noqa: F401
    revised_segment_tile, revised_segment_tile_plain, revised_tile,
)
from .simplex_tile import (  # noqa: F401
    segment_tile, segment_tile_plain, simplex_tile, simplex_tile_plain,
    smem_bytes, tableau_in_smem,
)
from .ssm_scan import (  # noqa: F401
    ssm_scan, ssm_scan_bt_ds, ssm_scan_bwd, ssm_scan_bwd_plain, ssm_scan_plain,
)
