"""Tableau-element work accounting of a lockstep batched solve, the
port's copy of the reference's ``obs.work``: the device steps a solve that
runs every LP until the slowest finishes executes, and the tableau
elements those steps touch.  Per-LP iteration counts come from
``LPResult.iterations`` or, identically, from the telemetry plane's
``phase1_iters + phase2_iters``.

The port's ``core`` is imported lazily inside the functions to keep the
obs package importable before (and independent of) the engine modules.
"""
from __future__ import annotations

import numpy as np


def lockstep_steps(iters) -> int:
    """Device steps a non-compacted lockstep solve executes for a batch
    with these per-LP iteration counts: every LP rides until the slowest
    finishes, plus the final all-converged check step."""
    iters = np.asarray(iters)
    return int(iters.max()) + 1 if iters.size else 0


def element_updates_lockstep(iters, m: int, n: int, *,
                             compacted: bool = False) -> float:
    """Tableau-element updates of a lockstep (non-scheduled) batched solve:
    ``(max(iters) + 1) * B * tableau_elements(m, n)``.

    ``iters`` may be per-LP iteration counts from ``LPResult.iterations``
    or the telemetry plane's ``phase1_iters + phase2_iters`` (identical by
    construction)."""
    from ..core.simplex import tableau_elements

    iters = np.asarray(iters)
    return float(lockstep_steps(iters) * iters.size
                 * tableau_elements(m, n, compacted=compacted))
