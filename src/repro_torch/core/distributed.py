"""Batched LP solving over several ranks: the batch split over a
``torch.distributed`` process group.

Counterpart of ``repro.core.distributed``, whose mesh becomes a process
group.  LPs are independent, so the batch is the only axis to split: it is
padded to a multiple of the world size with trivial LPs (max 0 s.t.
x <= 1), rank r solves the r-th contiguous block on its own device, and
the results are all-gathered so that every rank returns the whole
``LPResult``.  ``group=None`` is the default group when
``torch.distributed`` is initialised, and a world of one rank (no
collective) when it is not.  A rank's device is ``device=`` or, on a card,
``cuda:(rank % device_count)``; without a card and without
``device="cpu"`` the solvers raise.

* ``solve_pjit``: each rank runs the engine's whole solve on its block,
  on the card through the CUDA kernels (``kernels.ops.solve_batched_kernel``),
  on the CPU through their plain versions.  The reference's lockstep (one
  global while-loop, every chip stepping until the slowest LP is done) has
  no counterpart: the kernels exit per LP, so ``solve_pjit`` and the
  one-shot ``solve_shard_map`` compute the same thing.
* ``solve_shard_map(..., segment_k=K)``: the compaction scheduler
  (core/compaction.py ``run_schedule``) drives each rank's block in
  segments of at most K steps.  Survivors are counted over the world
  (the host status reads are all-gathered), and a gather goes to the next
  power-of-two bucket padded to the world size: the survivors' state is
  all-gathered and each rank takes its ``bucket / world`` lanes in the
  reference's global order.  So the results and the ``SegmentStat``
  ladder (``stats_out``) are those of one process running the same
  schedule with buckets padded to the world size.
* ``lower_only`` has no meaning here (the reference returns the XLA
  lowering of its jitted solve; the port launches eager kernels) and
  raises ``NotImplementedError``.

A ``GeneralLPBatch`` is canonicalized once on the host before the split
and recovered after the gather.  Collectives travel as host tensors over
gloo (which also serves ranks that share one card) and as device tensors
over NCCL (one card a rank); any other process-group backend raises.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..obs.report import SolveReport
from .compaction import SegmentStat, TorchBackend, map_state, run_schedule
from .forms import ensure_canonical, finish_result
from .lp import (LPBatch, LPResult, canonicalize_backend, default_max_iters)
from .pdhg import (DEFAULT_TOL, PdhgBackend, _check_pdhg_pricing,
                   default_pdhg_max_iters, pdhg_rounds)
from .revised import RevisedBackend
from .simplex import batch_tensors

LOWER_ONLY = ("lower_only=True has no torch meaning: the reference returns "
              "the XLA lowering of its jitted sharded solve, and the port "
              "launches eager CUDA kernels with no single computation to "
              "lower")


def _pad_batch(batch: LPBatch, multiple: int):
    """Pad the batch to a multiple of the world size with trivial LPs
    (max 0 s.t. x <= 1): they solve in one phase-2 check."""
    B = batch.batch
    pad = (-B) % multiple
    if pad == 0:
        return batch, B
    A = np.concatenate([batch.A, np.tile(np.eye(batch.m, batch.n)[None],
                                         (pad, 1, 1))])
    b = np.concatenate([batch.b, np.ones((pad, batch.m))])
    c = np.concatenate([batch.c, np.zeros((pad, batch.n))])
    ub = None
    if batch.ub is not None:
        ub = np.concatenate([batch.ub, np.full((pad, batch.n), np.inf)])
    return LPBatch(A=A, b=b, c=c, ub=ub), B


def _backend_defaults(backend: str, max_iters, tol, m: int, n: int):
    """The engine's loop cap and tolerance where the caller gives none:
    PDHG counts iterations (``default_pdhg_max_iters``) and its ``tol`` is
    the relative KKT tolerance (1e-5 in float32); the simplex engines keep
    the 1e-6 reduced-cost tolerance."""
    if backend == "pdhg":
        return (max_iters or default_pdhg_max_iters(m, n),
                DEFAULT_TOL if tol is None else tol)
    return max_iters or default_max_iters(m, n), 1e-6 if tol is None else tol


class World:
    """This rank's place in ``group`` and the collectives the solvers
    make: a world of one rank, with no collective, when
    ``torch.distributed`` is not initialised."""

    def __init__(self, group=None, device=None):
        if dist.is_available() and dist.is_initialized():
            self.group = group
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = dist.get_backend(group)
        else:
            if group is not None:
                raise ValueError("group given, but torch.distributed is not "
                                 "initialised")
            self.group, self.size, self.rank, self.backend = None, 1, 0, None
        self.device = rank_device(device, self.rank)
        if self.size == 1:
            self.via = None
        elif self.backend == "gloo":
            self.via = torch.device("cpu")
        elif self.backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError("the nccl backend needs each rank on a card, "
                                 f"not on {self.device}")
            self.via = self.device
        else:
            raise ValueError(f"collectives over {self.backend!r}: the solvers "
                             "gather over gloo (host tensors) or nccl (device "
                             "tensors)")

    def block(self, arr):
        """This rank's contiguous block of a global array or batch axis."""
        per = len(arr) // self.size
        return arr[self.rank * per:(self.rank + 1) * per]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated on axis 0, in
        rank order, on ``t``'s device."""
        if self.size == 1:
            return t
        src = t.to(torch.uint8) if t.dtype == torch.bool else t
        src = src.to(self.via).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts).to(t.device)
        return out.bool() if t.dtype == torch.bool else out

    def gather_np(self, a):
        """``gather`` for a NumPy array (None stays None)."""
        if a is None or self.size == 1:
            return a
        return self.gather(torch.from_numpy(np.ascontiguousarray(a))).numpy()

    def max(self, v: int) -> int:
        """The largest ``v`` over the ranks."""
        if self.size == 1:
            return int(v)
        t = torch.tensor([int(v)], dtype=torch.int64, device=self.via)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return int(t.item())


def rank_device(device, rank: int) -> torch.device:
    """``device`` as given, else ``cuda:(rank % device_count)``; raises
    without a card unless the caller names the CPU."""
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch engine")
    return torch.device("cuda", rank % torch.cuda.device_count())


class ShardedBackend:
    """``run_schedule``'s view of a batch split over the ranks: the state
    is this rank's block (``bucket / world`` lanes), and every host read,
    extraction and gather covers the global bucket in the reference's
    order.  Segments run ``local`` (a scheduler backend) on the block; a
    segment's steps are the most any rank took.  Every rank makes the
    same calls in the same order, since the schedule depends only on the
    gathered host arrays."""

    def __init__(self, local, world: World):
        self.local, self.world = local, world
        self.m, self.n = local.m, local.n
        self.pad_multiple = world.size

    def _run(self, runner, state, steps: int, max_iters: int):
        state, done = runner(state, steps, max_iters)
        return state, self.world.max(done)

    def run_phase1(self, state, steps: int, max_iters: int):
        return self._run(self.local.run_phase1, state, steps, max_iters)

    def run_phase2(self, state, steps: int, max_iters: int):
        return self._run(self.local.run_phase2, state, steps, max_iters)

    def compact_columns(self, state):
        return self.local.compact_columns(state)

    def deactivate(self, state, valid):
        return self.local.deactivate(
            state, self.world.block(np.asarray(valid).reshape(-1)))

    def take(self, state, idx):
        """The bucket gather: every rank's state all-gathered, then this
        rank's block of the global rows ``idx``."""
        whole = map_state(self.world.gather, state)
        return self.local.take(whole, self.world.block(np.asarray(idx)))

    def status_host(self, state) -> np.ndarray:
        return self.world.gather_np(self.local.status_host(state))

    def phase_host(self, state) -> np.ndarray:
        return self.world.gather_np(self.local.phase_host(state))

    def work_host(self, state) -> np.ndarray:
        return self.world.gather_np(self.local.work_host(state))

    def tel_host(self, state) -> dict:
        return {k: self.world.gather_np(v)
                for k, v in self.local.tel_host(state).items()}

    def extract(self, state, stage: str):
        return tuple(self.world.gather_np(a)
                     for a in self.local.extract(state, stage))

    def elements_per_step(self, stage: str) -> int:
        return self.local.elements_per_step(stage)


def _local_backend(backend: str, dev, m, n, tol, feas_tol, pricing,
                   refactor_period):
    """The scheduler backend of one rank's block: the CUDA segment kernels
    on a card, the plain engines on the CPU."""
    on_card = dev.type == "cuda"
    if backend == "pdhg":
        _check_pdhg_pricing(pricing)
        if on_card:
            from ..kernels.ops import PdhgKernelBackend
            return PdhgKernelBackend(m, n, tol)
        return PdhgBackend(m, n, tol)
    if backend == "revised":
        cls = RevisedBackend
        if on_card:
            from ..kernels.ops import RevisedKernelBackend as cls
        return cls(m, n, tol, feas_tol, pricing=pricing,
                   refactor_period=refactor_period)
    if on_card:
        from ..kernels.ops import KernelBackend, kernel_rule
        return KernelBackend(m, n, tol, feas_tol, pricing=kernel_rule(pricing))
    return TorchBackend(m, n, tol, feas_tol, pricing=pricing)


def _rank_block(batch: LPBatch, world: World):
    """(this rank's block of the padded batch, the padded batch size, the
    caller's batch size)."""
    padded, B = _pad_batch(batch, world.size)
    block = LPBatch(A=world.block(padded.A), b=world.block(padded.b),
                    c=world.block(padded.c),
                    ub=None if padded.ub is None else world.block(padded.ub))
    return block, padded.batch, B


def _solve_blocks(batch: LPBatch, world: World, *, backend, max_iters, tol,
                  feas_tol, pricing, refactor_period, telemetry,
                  tracer) -> LPResult:
    """Each rank's whole solve of its block, all-gathered."""
    from ..kernels.ops import solve_batched_kernel
    block, _, B = _rank_block(batch, world)
    res = solve_batched_kernel(
        block, device=world.device, backend=backend, max_iters=max_iters,
        tol=tol, feas_tol=feas_tol, pricing=pricing,
        refactor_period=refactor_period, telemetry=telemetry, tracer=tracer)
    field = lambda a: None if a is None else world.gather_np(a)[:B]  # noqa: E731
    stats = None
    if res.stats is not None:
        rep = res.stats
        stats = SolveReport(counters={k: field(v)
                                      for k, v in rep.counters.items()},
                            spans=rep.spans, wall_s=rep.wall_s,
                            backend=rep.backend)
    return LPResult(x=field(res.x), objective=field(res.objective),
                    status=field(res.status),
                    iterations=field(res.iterations), y=field(res.y),
                    z=field(res.z), stats=stats)


def solve_pjit(batch: LPBatch, group=None, *, device=None,
               tol: Optional[float] = None, feas_tol: float = 1e-5,
               max_iters: Optional[int] = None, lower_only: bool = False,
               pricing: str = "dantzig", backend: str = "tableau",
               refactor_period: Optional[int] = None, presolve: bool = True,
               scale: Optional[bool] = None, telemetry: bool = False,
               tracer=None) -> LPResult:
    """Each rank solves its block of the batch whole (module docstring);
    every rank returns the whole result.  ``backend``, ``pricing``,
    ``refactor_period``, ``telemetry`` and ``tracer`` as in
    ``kernels.ops.solve_batched_kernel``; ``tol=None`` resolves per
    engine."""
    return _solve(batch, group, device=device, tol=tol, feas_tol=feas_tol,
                  max_iters=max_iters, lower_only=lower_only,
                  pricing=pricing, backend=backend,
                  refactor_period=refactor_period, presolve=presolve,
                  scale=scale, telemetry=telemetry, tracer=tracer)


def solve_shard_map(batch: LPBatch, group=None, *, device=None,
                    tol: Optional[float] = None, feas_tol: float = 1e-5,
                    max_iters: Optional[int] = None, lower_only: bool = False,
                    segment_k: Optional[int] = None,
                    compact_threshold: Optional[float] = None,
                    pricing: str = "dantzig",
                    stats_out: Optional[List[SegmentStat]] = None,
                    backend: str = "tableau",
                    refactor_period: Optional[int] = None,
                    presolve: bool = True, scale: Optional[bool] = None,
                    telemetry: bool = False, tracer=None) -> LPResult:
    """Per-rank termination.  ``segment_k=None`` solves each block whole,
    as ``solve_pjit`` does; ``segment_k=K`` runs the blocks in K-step
    segments under the compaction scheduler with gathers over the world
    (module docstring; ``compact_threshold=None`` is
    ``auto_compact_threshold``, ``stats_out`` collects one ``SegmentStat``
    a segment, buckets multiples of the world size).  For PDHG a step is
    one check round and the budget ``ceil(max_iters / CHECK_EVERY)``
    rounds.  Results equal the single-device solver's."""
    return _solve(batch, group, device=device, tol=tol, feas_tol=feas_tol,
                  max_iters=max_iters, lower_only=lower_only,
                  segment_k=segment_k, compact_threshold=compact_threshold,
                  pricing=pricing, stats_out=stats_out, backend=backend,
                  refactor_period=refactor_period, presolve=presolve,
                  scale=scale, telemetry=telemetry, tracer=tracer)


def _solve(batch, group, *, device, tol, feas_tol, max_iters, lower_only,
           pricing, backend, refactor_period, presolve, scale, telemetry,
           tracer, segment_k=None, compact_threshold=None, stats_out=None):
    canonicalize_backend(backend)
    if lower_only:
        raise NotImplementedError(LOWER_ONLY)
    if stats_out is not None and segment_k is None:
        raise ValueError("stats_out requires segment_k: the one-shot solve "
                         "has no segment accounting to record")
    world = World(group, device)
    batch, rec = ensure_canonical(batch, presolve=presolve, scale=scale)
    m, n = batch.m, batch.n
    max_iters, tol = _backend_defaults(backend, max_iters, tol, m, n)
    if segment_k is None:
        res = _solve_blocks(batch, world, backend=backend,
                            max_iters=max_iters, tol=tol, feas_tol=feas_tol,
                            pricing=pricing, refactor_period=refactor_period,
                            telemetry=telemetry, tracer=tracer)
        return finish_result(rec, res)
    runner = _local_backend(backend, world.device, m, n, tol, feas_tol,
                            pricing, refactor_period)
    budget = max_iters
    if backend == "pdhg":
        budget = pdhg_rounds(max_iters, runner.check_every)
    block, B_pad, B = _rank_block(batch, world)
    A, b, c, ub = batch_tensors(block, world.device)
    state = runner.init(A, b, c, ub, telemetry=telemetry)
    del A, b, c, ub
    orig = np.where(np.arange(B_pad) < B, np.arange(B_pad), -1)
    sharded = ShardedBackend(runner, world)
    # padding LPs are not real work: retire them before the first segment
    state = sharded.deactivate(state, orig >= 0)
    res = run_schedule(sharded, state, max_iters=budget, segment_k=segment_k,
                       compact_threshold=compact_threshold,
                       stats_out=stats_out, orig=orig, tracer=tracer)
    return finish_result(rec, res)
