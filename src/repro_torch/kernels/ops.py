"""Batched entry points of the CUDA kernels.

``solve_batched_kernel`` is the counterpart of the tableau, revised and
pdhg branches of ``repro.kernels.ops.solve_batched_pallas``: same
``LPBatch`` -> ``LPResult`` contract as the engines (core/simplex.py,
core/revised.py, core/pdhg.py), and what core/batching.py
``solve_batched`` runs on the card.

* ``backend="tableau"``: with ``compaction=False`` one launch of the
  whole-solve kernel solves the batch; with ``compaction=True`` the
  scheduler of core/compaction.py drives the segment kernel through
  ``KernelBackend``, the counterpart of the reference's ``PallasBackend``.
  ``pricing="partial"`` degrades to dantzig with a warning, as in the
  reference: the kernels keep the whole cost row in shared memory, so
  block pricing saves nothing.  The tableau kernels have no warm-start
  injection: ``warm=`` warns and the solve starts cold, on the card, as
  the reference's tile kernel does.
* ``backend="revised"``: one launch of the revised kernel
  (``revised_tile``), with ``warm=`` injected and the result's ``warm``
  capture, or under the scheduler through ``RevisedKernelBackend``, the
  counterpart of ``RevisedPallasBackend``.
* ``backend="pdhg"``: one launch of the whole-solve PDHG kernel
  (``pdhg_tile``, either ``step_rule``), with ``warm=`` injected (x, y,
  omega; the reference's tile kernel starts cold) and the result's
  ``warm`` capture (x, y, omega, eta), or under the scheduler through
  ``PdhgKernelBackend``, the counterpart of ``PdhgPallasBackend`` (the
  fixed step only, as in the reference).  ``tol`` is the relative KKT
  tolerance and ``max_iters`` counts PDHG iterations.

A ``GeneralLPBatch`` is canonicalized on ingestion and recovered on the
way out.

``solve_hyperbox_kernel`` is the counterpart of ``solve_hyperbox_pallas``:
box-LP support values through the hyperbox kernel, NumPy in and out.
"""
from __future__ import annotations

import warnings
from typing import List, Optional

import numpy as np
import torch

from ..core.compaction import SegmentStat, TorchBackend, schedule_batch
from ..core.forms import ensure_canonical, finish_result, prepare_warm
from ..core.lp import (LPBatch, LPResult, WarmStart, canonicalize_backend,
                       default_max_iters)
from ..core.pdhg import (DEFAULT_TOL, PdhgBackend,
                         _check_pdhg_pricing, canonicalize_step_rule,
                         check_compacted_step_rule, default_pdhg_max_iters,
                         pdhg_result, schedule_pdhg, warm_tensors)
from ..core.pricing import canonicalize_rule
from ..core.revised import (RevisedBackend, auto_refactor_period,
                            canonicalize_revised_rule, revised_result)
from ..core.simplex import (batch_tensors, default_tolerances,
                            warm_basis_arrays)
from ..device import resolve_device
from .hyperbox_kernel import hyperbox_tile
from .pdhg_tile import pdhg_segment_tile, pdhg_tile
from .revised_tile import revised_segment_tile, revised_tile
from .simplex_tile import segment_tile, simplex_tile


class KernelBackend(TorchBackend):
    """Scheduler backend whose segments run the CUDA segment kernel
    (``segment_tile``; its plain version on CPU tensors).  State layout,
    gathers and extraction are ``TorchBackend``'s: the kernel works on the
    unpadded state, one block per LP, so there are no tiles to fill."""

    def segment(self, state, steps: int, stage: str, max_iters: int):
        return segment_tile(state, steps, stage=stage, m=self.m, n=self.n,
                            max_iters=max_iters, tol=self.tol,
                            pricing=self.rule)


class RevisedKernelBackend(RevisedBackend):
    """Scheduler backend whose segments run the CUDA revised kernel
    (``revised_segment_tile``; its plain version on CPU tensors).  State
    layout, gathers and extraction are ``RevisedBackend``'s; every launch
    refactorizes at its first step, so a gather needs no host-side
    refactorization."""

    def segment(self, state, steps: int, stage: str, max_iters: int):
        return revised_segment_tile(state, steps, stage=stage, m=self.m,
                                    n=self.n, max_iters=max_iters,
                                    tol=self.tol,
                                    refactor_period=self.refactor_period,
                                    rule=self.rule)


class PdhgKernelBackend(PdhgBackend):
    """Scheduler backend whose segments run the CUDA PDHG kernel
    (``pdhg_segment_tile``; its plain version on CPU tensors).  State
    layout, gathers and extraction are ``PdhgBackend``'s: one block per
    LP on the unpadded state, so there are no tiles to fill.  A round is
    the kernel's ``CHECK_EVERY`` iterations."""

    def __init__(self, m: int, n: int, tol: float = DEFAULT_TOL):
        super().__init__(m, n, tol)

    def segment(self, state, steps: int, stage: str, max_iters: int):
        return pdhg_segment_tile(state, steps, m=self.m, n=self.n,
                                 max_rounds=max_iters, tol=self.tol)


def solve_batched_kernel(batch: LPBatch, *, device=None,
                         max_iters: int | None = None,
                         tol: float | None = None,
                         feas_tol: float | None = None,
                         pricing: str = "dantzig",
                         presolve: bool = True,
                         scale: bool | None = None,
                         compaction: bool = False,
                         segment_k: Optional[int] = None,
                         compact_threshold: Optional[float] = None,
                         stats_out: Optional[List[SegmentStat]] = None,
                         backend: str = "tableau",
                         refactor_period: Optional[int] = None,
                         warm: Optional[WarmStart] = None,
                         step_rule: str = "fixed") -> LPResult:
    """Solve a batch through the CUDA kernels (their plain versions on
    ``device="cpu"``): one whole-solve launch, or with ``compaction=True``
    segments of at most ``segment_k`` steps under the compaction scheduler
    (``compact_threshold`` and ``stats_out`` as in
    ``core.compaction.solve_batched_compacted``).  ``backend`` is
    "tableau", "revised" (``refactor_period``: the revised eta clock) or
    "pdhg" (``step_rule`` as in ``core.pdhg.solve_batched_pdhg``);
    ``warm`` a parent's ``WarmStart``, injected by the revised and pdhg
    kernel paths and ignored with a warning by the tableau one."""
    batch, rec = ensure_canonical(batch, presolve=presolve, scale=scale)
    dev = resolve_device(device)
    m, n = batch.m, batch.n
    warm = prepare_warm(warm, rec, batch)
    if canonicalize_backend(backend) == "pdhg":
        return finish_result(rec, _solve_pdhg_kernel(
            batch, dev, max_iters=max_iters, tol=tol, pricing=pricing,
            compaction=compaction, segment_k=segment_k,
            compact_threshold=compact_threshold, stats_out=stats_out,
            warm=warm, step_rule=step_rule))
    if canonicalize_backend(backend) == "revised":
        return finish_result(rec, _solve_revised_kernel(
            batch, dev, max_iters=max_iters, tol=tol, feas_tol=feas_tol,
            pricing=pricing, compaction=compaction, segment_k=segment_k,
            compact_threshold=compact_threshold, stats_out=stats_out,
            refactor_period=refactor_period, warm=warm))
    if warm is not None:
        warnings.warn(
            "solve_batched_kernel(backend='tableau', warm=...): the tableau "
            "kernels have no warm-start injection; solving cold "
            "(backend='revised' injects)")
    rule = canonicalize_rule(pricing)
    if rule == "partial":
        warnings.warn(
            "solve_batched_kernel(pricing='partial'): the kernel keeps the "
            "full cost row in shared memory, so partial pricing saves "
            "nothing; using dantzig (identical certificates)")
        rule = "dantzig"
    tol, feas_tol = default_tolerances(tol, feas_tol)
    if compaction:
        runner = KernelBackend(m, n, tol, feas_tol, pricing=rule)
        return finish_result(rec, schedule_batch(
            runner, batch, dev, max_iters=max_iters, segment_k=segment_k,
            compact_threshold=compact_threshold, stats_out=stats_out))
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


def _solve_revised_kernel(batch: LPBatch, dev, *, max_iters, tol, feas_tol,
                          pricing, compaction, segment_k, compact_threshold,
                          stats_out, refactor_period, warm) -> LPResult:
    """The revised branch of ``solve_batched_kernel`` on a canonical batch
    with a validated carrier."""
    m, n = batch.m, batch.n
    rule = canonicalize_revised_rule(pricing)
    tol, feas_tol = default_tolerances(tol, feas_tol)
    K = int(refactor_period or auto_refactor_period(m, n))
    if compaction:
        runner = RevisedKernelBackend(m, n, tol, feas_tol, pricing=rule,
                                      refactor_period=K)
        return schedule_batch(runner, batch, dev, max_iters=max_iters,
                              segment_k=segment_k,
                              compact_threshold=compact_threshold,
                              stats_out=stats_out, warm=warm)
    if max_iters is None:
        max_iters = default_max_iters(m, n)
    A, b, c, ub = batch_tensors(batch, dev)
    out = revised_tile(A, b, c, ub, m=m, n=n, max_iters=int(max_iters),
                       tol=tol, feas_tol=feas_tol, refactor_period=K,
                       pricing=rule, **warm_basis_arrays(warm))
    return revised_result(out, m=m, n=n, rule=rule)


def _solve_pdhg_kernel(batch: LPBatch, dev, *, max_iters, tol, pricing,
                       compaction, segment_k, compact_threshold, stats_out,
                       warm, step_rule) -> LPResult:
    """The pdhg branch of ``solve_batched_kernel`` on a canonical batch
    with a validated carrier."""
    _check_pdhg_pricing(pricing)
    canonicalize_step_rule(step_rule)
    m, n = batch.m, batch.n
    tol = DEFAULT_TOL if tol is None else float(tol)
    if compaction:
        check_compacted_step_rule(step_rule)
        runner = PdhgKernelBackend(m, n, tol)
        return schedule_pdhg(runner, batch, dev, max_iters=max_iters,
                             segment_k=segment_k,
                             compact_threshold=compact_threshold,
                             stats_out=stats_out, warm=warm)
    if max_iters is None:
        max_iters = default_pdhg_max_iters(m, n)
    A, b, c, ub = batch_tensors(batch, dev)
    out = pdhg_tile(A, b, c, ub, m=m, n=n, max_iters=int(max_iters),
                    tol=tol, step_rule=step_rule,
                    **warm_tensors(warm, dev))
    return pdhg_result(out, m=m, n=n)


def solve_hyperbox_kernel(lo, hi, d, *, device=None) -> np.ndarray:
    """Box-LP support values through ``hyperbox_tile`` on ``device`` (CUDA
    unless ``device="cpu"``): lo, hi (B, n) and d (B, n) -> (B,), or d
    (K, n) -> (B, K).  NumPy in, float32 NumPy out."""
    dev = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev).contiguous()

    return hyperbox_tile(put(lo), put(hi), put(d)).cpu().numpy()
