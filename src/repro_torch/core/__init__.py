"""The port's solver core: containers, canonicalization, pricing, the
plain PyTorch engines (tableau, revised, restarted PDHG and its sparse
form), the compaction and frontier schedulers, the box-LP special case,
the chunked batched entry point, branch-and-bound, the solvers over a
``torch.distributed`` world and the MoE capacity router."""
from .batching import max_chunk_size, solve_batched  # noqa: F401
from .branch_bound import (  # noqa: F401
    BnBResult, branch_and_bound, safe_dual_bound,
)
from .compaction import (  # noqa: F401
    FrontierScheduler, SegmentStat, solve_batched_compacted,
)
from .distributed import solve_pjit, solve_shard_map  # noqa: F401
from .forms import (  # noqa: F401
    GeneralLPBatch, canonicalize, general_violation, random_general_lp_batch,
    rebind_bounds,
)
from .hyperbox import (  # noqa: F401
    hyperbox_as_general_lp, solve_hyperbox, solve_hyperbox_ref,
)
from .lp_router import expert_capacity_lp  # noqa: F401
from .lp import (  # noqa: F401
    INFEASIBLE, ITERATION_LIMIT, OPTIMAL, UNBOUNDED, LPBatch, LPResult,
    WarmStart,
)
from .pdhg import (  # noqa: F401
    solve_batched_pdhg, solve_batched_pdhg_compacted,
)
from .reference import (  # noqa: F401
    random_lp_batch, random_sparse_lp_batch, solve_batched_reference,
)
from .simplex import solve_batched_torch  # noqa: F401
from .sparse import SparseLPBatch, solve_batched_pdhg_sparse  # noqa: F401
