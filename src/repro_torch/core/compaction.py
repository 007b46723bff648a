"""Active-set compaction scheduler: resumable K-step segments with survivor
gathers between them.

Counterpart of ``repro.core.compaction``.  The solve runs in segments of at
most ``segment_k`` steps; after each one the host reads the status vector,
and when the running fraction drops below ``compact_threshold`` the
survivors are gathered (``index_select`` on the device) into the next
power-of-two bucket and the solve resumes.  Stage ``p1`` runs phase-1 LPs on
the full (m+2) x (n+2m+1) tableau; the batch is then phase-compacted once to
(m+1) x (n+m+1) and stage ``p2`` finishes phase 2 there.  An LP that reaches
phase 2 during stage p1 is parked until stage p2: its phase-2 steps on the
compacted tableau are the ones the unsegmented engine makes on the full one
(core/simplex.py), so gathering and parking change no LP's pivot sequence
and the results equal the unsegmented solver's bit for bit.

**The step budget is per LP**, as in the CUDA kernels: an LP steps only
while its own ``iters < max_iters``, inside the segment, and a segment marks
an LP that is still running at its cap ITERATION_LIMIT (stage p1: only an
LP still in phase 1, as loop 1 of the engine does).  The scheduler runs a
stage until no LP is pending.  The reference instead charges one shared
budget per segment (``budget -= max(1, done)``); with segments that stop
per LP or per tile, LPs that had nothing to do in stage p1 then find the
budget spent in stage p2 (ROADMAP.md, queue 3).  A running LP's own count
equals the unsegmented engine's shared step counter, so the per-LP budget
keeps the results equal to that engine's when ``max_iters`` binds.

``TorchBackend`` runs the segments with the plain engine on any device; on
the card ``kernels.ops.KernelBackend`` runs them through the CUDA segment
kernel.  The revised engine has its own backends (core/revised.py
``RevisedBackend``, ``kernels.ops.RevisedKernelBackend``) under the same
scheduler, and so has the first-order engine (core/pdhg.py
``PdhgBackend``, ``kernels.ops.PdhgKernelBackend``; one step is one PDHG
round and there is no phase 1).  A ``warm=`` carrier seeds the initial
state; the warm-derived leaves then ride the gathers.  Telemetry, tracing
and the frontier scheduler (``FrontierScheduler``, ``segment_combined``,
the backends' ``scatter``) are not ported yet and raise, naming their
ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from .forms import ensure_canonical, finish_result, prepare_warm
from .lp import (
    ITERATION_LIMIT,
    OPTIMAL,
    LPBatch,
    LPResult,
    WarmStart,
    canonicalize_backend,
    default_max_iters,
    resolve_backend,
)
from .pricing import canonicalize_rule
from .simplex import (
    _RUNNING,
    SimplexState,
    _step,
    batch_tensors,
    compact_tableau,
    default_tolerances,
    extract_duals,
    extract_solution,
    tableau_elements,
    warm_arrays,
    warm_tableau,
)

STAGES = ("p1", "p2")
WEIGHTED_RULES = ("steepest_edge", "devex")


class CompactionState(NamedTuple):
    """Resumable solver state; every leaf has the batch on axis 0, so a
    bucket gather is one ``index_select`` per leaf."""
    T: torch.Tensor       # (B, rows, C) f32: full in stage p1, compacted in p2
    basis: torch.Tensor   # (B, m) int32, full-tableau column indices
    phase: torch.Tensor   # (B,) int32
    status: torch.Tensor  # (B,) int32, _RUNNING until terminal
    iters: torch.Tensor   # (B,) int32
    w: torch.Tensor       # (B, n+m) f32 weights of the priceable columns;
                          #  a (B, 1) stub under dantzig and partial
    flip: torch.Tensor    # (B, n) bool: column stored complemented
    ub: torch.Tensor      # (B, n) f32 upper bounds, read-only
    thr: torch.Tensor     # (B,) f32 phase-1 feasibility threshold, read-only
    work: torch.Tensor    # (B, 3) int32: phase-1 pivots, phase-2 pivots,
                          #  bound flips


def auto_segment_k(m: int, n: int) -> int:
    """Segment length when the caller passes ``segment_k=None``: about 1/64
    of the ``default_max_iters`` cap, at least 4 (the reference's rule)."""
    return max(4, default_max_iters(m, n) // 64)


def auto_compact_threshold(segment_k: int) -> float:
    """Gather eagerness when the caller passes ``compact_threshold=None``:
    a gather costs about two state touches, and compacting at running
    fraction f saves (1 - f) * segment_k step slots over the next segment,
    so it pays once f <= segment_k / (segment_k + 2) (capped at 0.95)."""
    if segment_k < 1:
        raise ValueError(f"segment_k must be >= 1, got {segment_k}")
    return min(0.95, segment_k / (segment_k + 2.0))


def resolve_compact_threshold(compact_threshold: Optional[float],
                              segment_k: int) -> float:
    """``None`` -> ``auto_compact_threshold``; a float passes through."""
    if compact_threshold is None:
        return auto_compact_threshold(segment_k)
    return float(compact_threshold)


@dataclasses.dataclass(frozen=True)
class CompactionConfig:
    segment_k: int = 8              # max steps per segment
    compact_threshold: float = 0.5  # gather when running fraction < this

    def __post_init__(self):
        if self.segment_k < 1:
            raise ValueError(f"segment_k must be >= 1, got {self.segment_k}")


@dataclasses.dataclass
class SegmentStat:
    """Executed-work record of one segment."""
    stage: str           # "p1" (full tableau) or "p2" (compacted)
    bucket: int          # batch slots occupied during the segment
    steps: int           # steps the busiest LP took (<= segment_k)
    elements: int        # steps * bucket * tableau_elements(stage)
    survivors: int = -1  # running LPs after the segment


def next_bucket(active: int) -> int:
    """Next power of two >= active."""
    return 1 << max(0, active - 1).bit_length()


def segment_pending(state: CompactionState, stage: str,
                    max_iters: int) -> torch.Tensor:
    """(B,) bool: LPs that step in a segment of ``stage``: running, under
    their cap and, in stage p1, still in phase 1."""
    pend = (state.status == _RUNNING) & (state.iters < max_iters)
    if stage == "p1":
        pend &= state.phase == 1
    return pend


def run_segment(state: CompactionState, steps: int, *, stage: str, m: int,
                n: int, max_iters: int, tol: float, rule: str = "dantzig"):
    """At most ``steps`` steps of ``stage`` with the plain engine.

    Each LP steps while ``segment_pending`` holds for it; afterwards an LP
    that is still running at its cap is marked ITERATION_LIMIT (in stage
    p1 only one still in phase 1).  Returns ``(state, it)`` with ``it`` the
    (B,) int32 count of steps each LP took.  Builds new tensors; the input
    state is left as it was."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    full = stage == "p1"
    B, _, C = state.T.shape
    w = state.w
    if rule in WEIGHTED_RULES:
        # the engine keeps a weight per tableau column; the columns past
        # n+m are never priced, so their values do not matter
        w = torch.cat([w, torch.ones((B, C - (n + m)), dtype=w.dtype,
                                     device=w.device)], dim=1)
    s = SimplexState(state.T, state.basis, state.phase, state.status,
                     state.iters, w, state.flip, state.ub, state.work)
    it = torch.zeros((B,), dtype=torch.int32, device=state.T.device)
    for _ in range(int(steps)):
        act = segment_pending(s, stage, max_iters)
        if not bool(act.any()):
            break
        s = _step(s, n=n, m=m, tol=tol, feas_thr=state.thr if full else None,
                  rule=rule, full=full, active=act)
        it += act.to(torch.int32)
    capped = (s.status == _RUNNING) & (s.iters >= max_iters)
    if full:
        capped &= s.phase == 1
    status = torch.where(capped, ITERATION_LIMIT, s.status).to(torch.int32)
    w = s.w[:, :n + m].contiguous() if rule in WEIGHTED_RULES else s.w
    return CompactionState(s.T, s.basis, s.phase, status, s.iters, w, s.flip,
                           state.ub, state.thr, s.work), it


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name} is not ported to repro_torch yet (ROADMAP.md, queue 1 "
        "item 12: branch-and-bound streams its frontier through it)")


def segment_combined(state, steps, *, m, n, tol, rule="dantzig"):
    """Combined two-phase segments on the full tableau, for the frontier
    scheduler: not ported yet."""
    _not_ported("segment_combined")


class FrontierScheduler:
    """Continuous batching over a work producer (admits new LPs into lanes
    freed by retired ones): not ported yet."""

    def __init__(self, *args, **kwargs):
        _not_ported("FrontierScheduler")


class TorchBackend:
    """Segment runners on the plain PyTorch engine (any device); the
    counterpart of the reference's ``JaxBackend``.  No backend of the port
    pads its batch, so every slot holds one of the caller's LPs until a
    gather fills a bucket."""

    def __init__(self, m: int, n: int, tol: float, feas_tol: float,
                 pricing: str = "dantzig"):
        self.m, self.n = m, n
        self.tol, self.feas_tol = float(tol), float(feas_tol)
        self.rule = canonicalize_rule(pricing)

    def init(self, A, b, c, ub=None,
             warm: WarmStart | None = None) -> CompactionState:
        """The initial state, cold or seeded per LP from ``warm`` (a
        validated carrier; see ``core.simplex.warm_tableau``)."""
        m, n = self.m, self.n
        B, dev = A.shape[0], A.device
        if ub is None:
            ub = torch.full((B, n), torch.inf, dtype=A.dtype, device=dev)
        T, basis, phase, flip, w = warm_tableau(
            A, b, c, ub, m=m, n=n, feas_tol=self.feas_tol, rule=self.rule,
            **warm_arrays(warm, self.rule, m, n))
        # dantzig and partial never read weights: a (B, 1) stub keeps the
        # segments and gathers from moving a dead (B, n+m) array
        w = (w[:, :n + m].contiguous() if self.rule in WEIGHTED_RULES
             else torch.ones((B, 1), dtype=T.dtype, device=dev))
        return CompactionState(
            T=T, basis=basis, phase=phase,
            status=torch.full((B,), _RUNNING, dtype=torch.int32, device=dev),
            iters=torch.zeros((B,), dtype=torch.int32, device=dev), w=w,
            flip=flip, ub=ub.contiguous(),
            thr=(self.feas_tol * torch.clamp(T[:, m + 1, -1], min=1.0)
                 ).contiguous(),
            work=torch.zeros((B, 3), dtype=torch.int32, device=dev))

    def segment(self, state, steps: int, stage: str, max_iters: int):
        """One segment: ``(state, it)`` as ``run_segment`` returns them."""
        return run_segment(state, steps, stage=stage, m=self.m, n=self.n,
                           max_iters=max_iters, tol=self.tol, rule=self.rule)

    def _run(self, state, steps, max_iters, stage):
        state, it = self.segment(state, steps, stage, max_iters)
        return state, int(it.max()) if it.numel() else 0

    def run_phase1(self, state, steps: int, max_iters: int):
        return self._run(state, steps, max_iters, "p1")

    def run_phase2(self, state, steps: int, max_iters: int):
        return self._run(state, steps, max_iters, "p2")

    def compact_columns(self, state: CompactionState) -> CompactionState:
        """One-shot phase compaction of the whole bucket (weights already
        hold only the priceable columns, so they stay)."""
        return state._replace(T=compact_tableau(state.T, m=self.m, n=self.n))

    def deactivate(self, state: CompactionState, valid) -> CompactionState:
        """Mark the slots where ``valid`` is false terminal (ITERATION_LIMIT)
        so they never count as running: a gather's fill slots."""
        valid = torch.as_tensor(np.asarray(valid).reshape(-1),
                                device=state.status.device)
        return state._replace(status=torch.where(
            valid, state.status, ITERATION_LIMIT).to(torch.int32))

    def take(self, state, idx):
        """The bucket gather: every leaf's rows ``idx``, on the device."""
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                              device=state.status.device)
        return type(state)(*(leaf.index_select(0, idx) for leaf in state))

    def status_host(self, state) -> np.ndarray:
        return state.status.cpu().numpy()

    def work_host(self, state) -> np.ndarray:
        return state.work.cpu().numpy()

    def phase_host(self, state) -> np.ndarray:
        return state.phase.cpu().numpy()

    def extract(self, state: CompactionState, stage: str):
        """(x, obj, status, iters, y, z) as NumPy; RUNNING reads as the
        iteration limit, objectives and duals are NaN off OPTIMAL."""
        m, n = self.m, self.n
        x, obj = extract_solution(state.T, state.basis, m=m, n=n,
                                  flip=state.flip, ub=state.ub)
        y, z = extract_duals(state.T, m=m, n=n, flip=state.flip)
        status = torch.where(state.status == _RUNNING, ITERATION_LIMIT,
                             state.status)
        opt = status == OPTIMAL
        out = (x, torch.where(opt, obj, torch.nan), status.to(torch.int8),
               state.iters, torch.where(opt[:, None], y, torch.nan),
               torch.where(opt[:, None], z, torch.nan))
        return tuple(t.cpu().numpy() for t in out)

    def elements_per_step(self, stage: str) -> int:
        return tableau_elements(self.m, self.n, compacted=(stage == "p2"))

    def run_combined(self, state, steps: int, max_iters: int):
        _not_ported("TorchBackend.run_combined")

    def scatter(self, state, new_state, idx):
        _not_ported("TorchBackend.scatter")


def run_schedule(backend, state: CompactionState, *,
                 max_iters: Optional[int] = None,
                 segment_k: Optional[int] = None,
                 compact_threshold: Optional[float] = None,
                 stats_out: Optional[List[SegmentStat]] = None,
                 work_out: Optional[np.ndarray] = None) -> LPResult:
    """Drive a backend from its initial ``state`` (``backend.init``) through
    segmented stage p1 (full tableau) and stage p2 (phase-compacted) with
    survivor gathers in between.

    ``max_iters`` is each LP's own step budget; ``None`` takes
    ``default_max_iters``, ``segment_k=None`` ``auto_segment_k`` and
    ``compact_threshold=None`` ``auto_compact_threshold``.  Results land in
    dense (B, ...) arrays: retired LPs are flushed right before every
    gather, survivors at the end.  ``stats_out`` (a list) collects one
    ``SegmentStat`` per segment; ``work_out``, a (B, 3) integer array when
    given, receives each LP's phase-1 pivots, phase-2 pivots and bound
    flips."""
    m, n = backend.m, backend.n
    if max_iters is None:
        max_iters = default_max_iters(m, n)
    if segment_k is None:
        segment_k = auto_segment_k(m, n)
    config = CompactionConfig(
        segment_k=int(segment_k),
        compact_threshold=resolve_compact_threshold(compact_threshold,
                                                    int(segment_k)))
    max_iters = int(max_iters)
    B = int(state.status.shape[0])
    # orig[i]: the caller's batch index in slot i (-1 for a gather's fill)
    orig = np.arange(B, dtype=np.int64)
    out_x = np.zeros((B, n), np.float32)
    out_obj = np.full((B,), np.nan, np.float32)
    out_status = np.full((B,), ITERATION_LIMIT, np.int8)
    out_iters = np.zeros((B,), np.int32)
    duals = {}

    def flush(state, orig, stage):
        x, obj, status, iters, y, z = backend.extract(state, stage)
        sel = orig >= 0
        oi = orig[sel]
        out_x[oi] = x[sel]
        out_obj[oi] = obj[sel]
        out_status[oi] = status[sel]
        out_iters[oi] = iters[sel]
        if not duals:
            duals["y"] = np.full((B, y.shape[1]), np.nan, np.float32)
            duals["z"] = np.full((B, z.shape[1]), np.nan, np.float32)
        duals["y"][oi] = y[sel]
        duals["z"][oi] = z[sel]
        if work_out is not None:
            work_out[oi] = backend.work_host(state)[sel]

    def maybe_compact(state, orig, stage):
        """(state, orig, host status): the one status read per segment."""
        status = backend.status_host(state)
        running = status == _RUNNING
        n_run = int(running.sum())
        cur = len(orig)
        if n_run == 0:
            return state, orig, status
        bucket = next_bucket(n_run)
        if bucket >= cur or n_run >= config.compact_threshold * cur:
            return state, orig, status
        # retire everyone's current results, then gather the survivors
        flush(state, orig, stage)
        idx = np.nonzero(running)[0]
        fill = idx[np.arange(bucket - len(idx)) % len(idx)]
        state = backend.take(state, np.concatenate([idx, fill]))
        valid = np.arange(bucket) < len(idx)
        state = backend.deactivate(state, valid)
        orig = np.where(valid, np.concatenate([orig[idx], orig[fill]]), -1)
        # survivors are running, fill slots were just made terminal
        return state, orig, np.where(valid, _RUNNING, ITERATION_LIMIT)

    def run_stage(state, orig, stage, runner, pending):
        status = backend.status_host(state)
        # each segment steps every pending LP at least once or marks it at
        # its cap, so the stage ends
        while pending(state, status):
            bucket = len(orig)
            state, done = runner(state, config.segment_k, max_iters)
            state, orig, status = maybe_compact(state, orig, stage)
            if stats_out is not None:
                stats_out.append(SegmentStat(
                    stage=stage, bucket=bucket, steps=done,
                    elements=done * bucket * backend.elements_per_step(stage),
                    survivors=int((status == _RUNNING).sum())))
        return state, orig

    def pending_p1(state, status):
        phase = backend.phase_host(state)
        return bool(np.any((status == _RUNNING) & (phase == 1)))

    def pending_p2(state, status):
        return bool(np.any(status == _RUNNING))

    # stage p1 ends with no LP running in phase 1: each is in phase 2 or
    # terminal, so the compacted tableau holds every running LP whole
    state, orig = run_stage(state, orig, "p1", backend.run_phase1, pending_p1)
    state = backend.compact_columns(state)
    state, orig = run_stage(state, orig, "p2", backend.run_phase2, pending_p2)
    flush(state, orig, "p2")
    return LPResult(x=out_x, objective=out_obj, status=out_status,
                    iterations=out_iters, y=duals["y"], z=duals["z"])


def check_deferred(*, backend="tableau", telemetry=False,
                   tracer=None) -> None:
    """Validate ``backend`` and raise for the scheduler options the port
    has not reached yet: telemetry and tracing."""
    canonicalize_backend(backend)
    if telemetry or tracer is not None:
        raise NotImplementedError(
            "telemetry and tracing are not ported to repro_torch yet "
            "(ROADMAP.md, queue 1 item 11: obs/)")


def schedule_batch(runner, batch: LPBatch, dev, *, max_iters, segment_k,
                   compact_threshold, stats_out, warm=None) -> LPResult:
    """Initialize ``runner`` (a backend) on a canonical batch, seeded from
    ``warm`` (a validated carrier) when given, and drive it through
    ``run_schedule``; shared by the plain and kernel entry points."""
    A, b, c, ub = batch_tensors(batch, dev)
    state = runner.init(A, b, c, ub, warm=warm)
    del A, b, c
    return run_schedule(runner, state, max_iters=max_iters,
                        segment_k=segment_k,
                        compact_threshold=compact_threshold,
                        stats_out=stats_out)


def solve_batched_compacted(batch: LPBatch, *, device=None,
                            tol: Optional[float] = None,
                            feas_tol: Optional[float] = None,
                            max_iters: Optional[int] = None,
                            segment_k: Optional[int] = None,
                            compact_threshold: Optional[float] = None,
                            pricing: str = "dantzig",
                            backend: str = "tableau",
                            stats_out: Optional[List[SegmentStat]] = None,
                            presolve: bool = True,
                            scale: Optional[bool] = None,
                            warm: Optional[WarmStart] = None,
                            telemetry: bool = False,
                            tracer=None) -> LPResult:
    """Solve a batch with phase compaction and the active-set scheduler on
    the plain engine, in float32 on ``device`` (CUDA unless
    ``device="cpu"``).  A ``GeneralLPBatch`` is canonicalized on ingestion
    and recovered on the way out.

    Statuses, iterations, x and objectives equal ``solve_batched_torch``'s
    with the same ``pricing`` (and ``warm``) bit for bit; only the executed
    work changes.  ``segment_k=None`` derives the segment length
    (``auto_segment_k``), ``compact_threshold=None`` the gather eagerness
    (``auto_compact_threshold``); ``stats_out`` (a list) collects one
    ``SegmentStat`` per segment.  ``warm`` seeds the initial state; results
    carry no warm-start capture.  ``backend="revised"`` routes to
    ``core.revised.solve_batched_revised_compacted``, ``backend="pdhg"`` to
    ``core.pdhg.solve_batched_pdhg_compacted``."""
    check_deferred(backend=backend, telemetry=telemetry, tracer=tracer)
    if backend != "tableau":
        return resolve_backend(backend, compacted=True)(
            batch, device=device, tol=tol, feas_tol=feas_tol,
            max_iters=max_iters, segment_k=segment_k,
            compact_threshold=compact_threshold, pricing=pricing,
            stats_out=stats_out, presolve=presolve, scale=scale, warm=warm)
    batch, rec = ensure_canonical(batch, presolve=presolve, scale=scale)
    dev = resolve_device(device)
    tol, feas_tol = default_tolerances(tol, feas_tol)
    runner = TorchBackend(batch.m, batch.n, tol, feas_tol, pricing=pricing)
    res = schedule_batch(runner, batch, dev, max_iters=max_iters,
                         segment_k=segment_k,
                         compact_threshold=compact_threshold,
                         stats_out=stats_out,
                         warm=prepare_warm(warm, rec, batch))
    return finish_result(rec, res)
