"""MoE expert-capacity allocation as batched LPs: the paper's technique
inside the LM stack.

Counterpart of ``repro.core.lp_router``.  Standard token-choice MoE fixes a
uniform per-expert capacity and drops overflow tokens; under skewed routing
that wastes slots on cold experts while hot experts drop tokens.  Instead,
per token group g, solve the small LP

    maximize   sum_e  u_ge * x_ge          (u = router demand per expert)
    subject to sum_e  x_ge       <= S*k    (total dispatch slots in the group)
               x_ge              <= c_max  (per-expert ceiling)
               x_ge              <= d_ge   (never beyond demand)
               x  >= 0

One LP per group with E variables: the paper's workload shape, solved on
the device by the whole-solve simplex kernel with no host round trip (on
a CPU tensor, by its plain version).  The allocation carries no gradient,
as capacity truncation does not.
"""
from __future__ import annotations

import torch

from .lp import OPTIMAL


def expert_capacity_lp(demand: torch.Tensor, total_slots: float,
                       c_max: float) -> torch.Tensor:
    """demand: (G, E) nonnegative routing mass per group and expert.
    Returns the (G, E) float32 slot allocations solving the LP above, on
    ``demand``'s device, detached.  A group whose LP does not end OPTIMAL
    gets the uniform capacity ``min(total_slots / E, c_max)``."""
    from ..kernels.simplex_tile import simplex_tile

    G, E = demand.shape
    d = demand.detach().to(torch.float32)
    opts = dict(dtype=torch.float32, device=d.device)
    # One real constraint, sum_e x <= total_slots; the per-expert ceilings
    # x_e <= c_max and x_e <= d_e fold into the native upper bounds
    # ub_e = min(c_max, d_e), which the bounded ratio test handles at no
    # row cost
    m = 1
    A = torch.ones((G, m, E), **opts)
    b = torch.full((G, m), float(total_slots), **opts)
    ub = torch.minimum(torch.full((G, E), float(c_max), **opts), d)
    c = d + 1e-3   # demand-weighted allocation; the epsilon breaks ties
    x, _, status, _, _, _ = simplex_tile(
        A, b, c, ub.contiguous(), m=m, n=E, max_iters=8 * (m + E) + 50,
        tol=1e-6, feas_tol=1e-5)
    uniform = min(float(total_slots) / E, float(c_max))
    return torch.where((status == OPTIMAL)[:, None], x, uniform).detach()
