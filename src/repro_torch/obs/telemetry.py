"""Per-LP solver counters: the port's telemetry plane.

Counterpart of ``repro.obs.telemetry``.  ``TelemetryState`` is a
NamedTuple of per-LP ``(B,)`` tensors that rides as a trailing ``tel``
field on the engine states (``SimplexState``, ``RevisedState``,
``PdhgState``) and on the scheduler's ``CompactionState``.  With
telemetry off the field is ``None``: no counter tensor is allocated and
every step runs exactly the operations it runs without the plane.  With
``telemetry=True`` each step updates the lanes behind an ``if state.tel is
not None`` branch, the bucket gathers carry them like any other leaf, and
the CUDA segment kernels carry them as two packed rows per LP
(``tel_to_rows``: ``INT_ROW_WIDTH`` int32 and ``F32_ROW_WIDTH`` float32
columns, in the lane order of ``INT_LANES`` and ``F32_LANES``), which
they update in place.

Lane semantics (every lane is per LP, shape ``(B,)``):

int32 lanes
    ``phase1_iters`` / ``phase2_iters``: the engine's ``iterations``
      counter split by the phase an LP was in when the step began.  The
      increment mask is the one the engines add to ``iters`` (it
      includes the phase-transition and terminal steps), so
      ``phase1_iters + phase2_iters == LPResult.iterations`` exactly.
    ``phase1_pivots`` / ``phase2_pivots``: basis-changing pivots per
      phase (no bound flips, no transition steps).
    ``bound_flips``: entering columns that reached their own upper bound
      (a flip instead of a pivot).
    ``degenerate_pivots``: pivots whose minimum ratio was exactly zero.
    ``refactorizations``: revised engine: refactorizations of the basis
      inverse.  The port refactorizes at an LP's first step in every
      segment (the whole solve is one segment) and again every
      ``refactor_period`` pivots, and counts each one there.
    ``eta_len``: revised engine: pivots since the LP's last
      refactorization, after its last step.
    ``block_rotations``: revised engine, partial pricing: steps where the
      LP's block priced out and the full pass was consulted.
    ``restarts``: PDHG: adopted restarts.

float32 lanes
    ``kkt_primal`` / ``kkt_dual`` / ``kkt_gap``: PDHG: the KKT residual
      triple of the candidate at the LP's last check round (the three
      whose maximum is the convergence test).
    ``omega``: PDHG: the primal weight after the LP's last check round.

Lanes an engine does not own stay zero, so a ``SolveReport`` built from
them reads the same on every backend.  Every lane moves only in a step
the LP itself takes: a terminal LP's counters never change again, so they
do not depend on which other LPs share its batch or bucket.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INT_LANES = (
    "phase1_iters", "phase2_iters", "phase1_pivots", "phase2_pivots",
    "bound_flips", "degenerate_pivots", "refactorizations", "eta_len",
    "block_rotations", "restarts",
)
F32_LANES = ("kkt_primal", "kkt_dual", "kkt_gap", "omega")
ALL_LANES = INT_LANES + F32_LANES

# name -> column of the packed rows (csrc/*.cu use the same numbers)
INT_LANE = {name: i for i, name in enumerate(INT_LANES)}
F32_LANE = {name: i for i, name in enumerate(F32_LANES)}
# widths of the packed rows; the columns past the lanes are dead
INT_ROW_WIDTH = 16
F32_ROW_WIDTH = 8


class TelemetryState(NamedTuple):
    """Per-LP counter lanes; every leaf is a ``(B,)`` tensor."""

    phase1_iters: torch.Tensor
    phase2_iters: torch.Tensor
    phase1_pivots: torch.Tensor
    phase2_pivots: torch.Tensor
    bound_flips: torch.Tensor
    degenerate_pivots: torch.Tensor
    refactorizations: torch.Tensor
    eta_len: torch.Tensor
    block_rotations: torch.Tensor
    restarts: torch.Tensor
    kkt_primal: torch.Tensor
    kkt_dual: torch.Tensor
    kkt_gap: torch.Tensor
    omega: torch.Tensor


def init_telemetry(B: int, device=None) -> TelemetryState:
    """All-zero counter lanes for a batch of ``B`` LPs on ``device``."""
    return rows_to_tel(
        torch.zeros((B, INT_ROW_WIDTH), dtype=torch.int32, device=device),
        torch.zeros((B, F32_ROW_WIDTH), dtype=torch.float32, device=device))


def _add(lane: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return lane + mask.to(torch.int32)


def tel_simplex_update(tel: TelemetryState, *, inc, in_phase1, do_pivot,
                       do_flip, degenerate) -> TelemetryState:
    """One simplex step (tableau or revised).  ``inc`` is the mask the
    engine adds to ``iters`` this step, ``in_phase1`` the phase before the
    step, ``do_pivot``/``do_flip``/``degenerate`` the step kinds; every
    mask is a (B,) bool tensor."""
    p1, piv = in_phase1, do_pivot
    return tel._replace(
        phase1_iters=_add(tel.phase1_iters, inc & p1),
        phase2_iters=_add(tel.phase2_iters, inc & ~p1),
        phase1_pivots=_add(tel.phase1_pivots, piv & p1),
        phase2_pivots=_add(tel.phase2_pivots, piv & ~p1),
        bound_flips=_add(tel.bound_flips, do_flip),
        degenerate_pivots=_add(tel.degenerate_pivots, piv & degenerate))


def tel_revised_update(tel: TelemetryState, *, refactor=None, eta_len=None,
                       block_rotation=None) -> TelemetryState:
    """The revised engine's lanes: ``refactor`` (a (B,) bool mask) counts
    refactorizations, ``eta_len`` (B,) overwrites the eta-length lane,
    ``block_rotation`` (a mask) counts partial-pricing rotations."""
    kw = {}
    if refactor is not None:
        kw["refactorizations"] = _add(tel.refactorizations, refactor)
    if eta_len is not None:
        kw["eta_len"] = eta_len.to(torch.int32)
    if block_rotation is not None:
        kw["block_rotations"] = _add(tel.block_rotations, block_rotation)
    return tel._replace(**kw)


def tel_pdhg_update(tel: TelemetryState, *, inc_iters=None, restart=None,
                    kkt=None, omega=None) -> TelemetryState:
    """One PDHG check round: ``inc_iters`` (B,) int adds to
    ``phase2_iters`` (the engine has no phase 1), ``restart`` (a mask)
    counts adopted restarts, ``kkt`` the (rp, rd, gap) triple and ``omega``
    the primal weight overwrite their lanes."""
    kw = {}
    if inc_iters is not None:
        kw["phase2_iters"] = _add(tel.phase2_iters, inc_iters)
    if restart is not None:
        kw["restarts"] = _add(tel.restarts, restart)
    if kkt is not None:
        rp, rd, gap = kkt
        kw.update(kkt_primal=rp.to(torch.float32),
                  kkt_dual=rd.to(torch.float32),
                  kkt_gap=gap.to(torch.float32))
    if omega is not None:
        kw["omega"] = omega.to(torch.float32)
    return tel._replace(**kw)


def tel_to_rows(tel: TelemetryState):
    """The lanes packed into the rows the CUDA segment kernels read and
    update in place: ``(int_rows (B, INT_ROW_WIDTH) int32, f32_rows (B,
    F32_ROW_WIDTH) float32)``, new contiguous tensors."""
    def pack(names, width, dtype):
        lanes = [getattr(tel, name).to(dtype) for name in names]
        rows = torch.zeros((lanes[0].shape[0], width), dtype=dtype,
                           device=lanes[0].device)
        rows[:, :len(names)] = torch.stack(lanes, dim=1)
        return rows

    return (pack(INT_LANES, INT_ROW_WIDTH, torch.int32),
            pack(F32_LANES, F32_ROW_WIDTH, torch.float32))


def rows_to_tel(int_rows: torch.Tensor, f32_rows: torch.Tensor
                ) -> TelemetryState:
    """Inverse of ``tel_to_rows``: the lanes as column views of the rows
    (no copy)."""
    kw = {name: int_rows[:, INT_LANE[name]] for name in INT_LANES}
    kw.update({name: f32_rows[:, F32_LANE[name]] for name in F32_LANES})
    return TelemetryState(**kw)


def tel_to_numpy(tel: TelemetryState) -> dict:
    """The lanes as a ``{lane: np.ndarray}`` dict on the host (two device
    to host copies)."""
    ints, f32s = (rows.cpu().numpy() for rows in tel_to_rows(tel))
    out = {name: ints[:, INT_LANE[name]].copy() for name in INT_LANES}
    out.update({name: f32s[:, F32_LANE[name]].copy() for name in F32_LANES})
    return out


def zeros_numpy(B: int) -> dict:
    """Host-side all-zero counters: the flush target of a scheduled solve,
    filled per original LP index as LPs retire."""
    out = {name: np.zeros(B, np.int32) for name in INT_LANES}
    out.update({name: np.zeros(B, np.float32) for name in F32_LANES})
    return out
