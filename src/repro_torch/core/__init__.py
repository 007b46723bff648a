"""The port's solver core: containers, canonicalization, pricing, the
plain PyTorch engines (tableau, revised, restarted PDHG and its sparse
form), the compaction scheduler, the box-LP special case and the chunked
batched entry point."""
from .batching import max_chunk_size, solve_batched  # noqa: F401
from .compaction import (  # noqa: F401
    SegmentStat, solve_batched_compacted,
)
from .forms import GeneralLPBatch, canonicalize  # noqa: F401
from .hyperbox import (  # noqa: F401
    hyperbox_as_general_lp, solve_hyperbox, solve_hyperbox_ref,
)
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
