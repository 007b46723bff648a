"""Batched entry point of the CUDA tableau kernel.

``solve_batched_kernel`` is the counterpart of the tableau,
``compaction=False`` branch of ``repro.kernels.ops.solve_batched_pallas``:
same ``LPBatch`` -> ``LPResult`` contract as core/simplex.py
``solve_batched_torch``, and what core/batching.py ``solve_batched`` runs on
the card.  A ``GeneralLPBatch`` is canonicalized on ingestion and recovered
on the way out.  ``pricing="partial"`` degrades to dantzig with a warning,
as in the reference: the kernel keeps the whole cost row in shared memory,
so block pricing saves nothing.  The kernel captures no warm-start state.
"""
from __future__ import annotations

import warnings

from ..core.forms import ensure_canonical, finish_result
from ..core.lp import LPBatch, LPResult, default_max_iters
from ..core.pricing import canonicalize_rule
from ..core.simplex import batch_tensors, default_tolerances
from ..device import resolve_device
from .simplex_tile import simplex_tile


def solve_batched_kernel(batch: LPBatch, *, device=None,
                         max_iters: int | None = None,
                         tol: float | None = None,
                         feas_tol: float | None = None,
                         pricing: str = "dantzig",
                         presolve: bool = True,
                         scale: bool | None = None) -> LPResult:
    """Solve a batch through ``kernels.simplex_tile`` (the kernel on cuda,
    its plain version on ``device="cpu"``)."""
    batch, rec = ensure_canonical(batch, presolve=presolve, scale=scale)
    dev = resolve_device(device)
    m, n = batch.m, batch.n
    rule = canonicalize_rule(pricing)
    if rule == "partial":
        warnings.warn(
            "solve_batched_kernel(pricing='partial'): the kernel keeps the "
            "full cost row in shared memory, so partial pricing saves "
            "nothing; using dantzig (identical certificates)")
        rule = "dantzig"
    tol, feas_tol = default_tolerances(tol, feas_tol)
    if max_iters is None:
        max_iters = default_max_iters(m, n)
    A, b, c, ub = batch_tensors(batch, dev)
    x, obj, status, iters, y, z = simplex_tile(
        A, b, c, ub, m=m, n=n, max_iters=int(max_iters), tol=tol,
        feas_tol=feas_tol, pricing=rule)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    res = LPResult(x=host(x), objective=host(obj), status=host(status),
                   iterations=host(iters), y=host(y), z=host(z))
    return finish_result(rec, res)
