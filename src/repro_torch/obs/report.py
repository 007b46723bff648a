"""Per-solve aggregation: ``SolveReport`` attached as ``LPResult.stats``.

A ``SolveReport`` bundles the per-LP counter lanes collected by the
on-device telemetry plane (``obs.telemetry``) with the host-side span tree
(``obs.trace``) and the end-to-end wall-clock of the solve.  It supports
the same ``take`` / ``slice`` / ``concat`` algebra as ``WarmStart`` so the
chunked driver can split, solve, and reassemble reports alongside results,
and offers batch-level views (percentiles, histograms, a printable
summary) for bench scripts and the serving example.

NumPy-only, no torch, so reports are cheap to hold on the host.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np

from .telemetry import ALL_LANES, F32_LANES, INT_LANES
from .trace import Span, spans_to_perfetto

__all__ = ["SolveReport", "Span", "report_from_counters",
           "INT_LANES", "F32_LANES", "ALL_LANES"]


@dataclasses.dataclass(frozen=True)
class SolveReport:
    """Telemetry for one batched solve.

    ``counters`` maps lane name -> per-LP ``(B,)`` array (see
    ``obs.telemetry`` for lane semantics).  ``spans`` is the host span tree
    (empty for monolithic solves without a tracer).  ``wall_s`` is the
    end-to-end host wall-clock of the solve that produced it."""

    counters: dict
    spans: tuple = ()
    wall_s: float = 0.0
    backend: str = ""

    # -- shape algebra (mirrors WarmStart) ----------------------------------

    @property
    def batch_size(self) -> int:
        for v in self.counters.values():
            return int(np.asarray(v).shape[0])
        return 0

    def _map(self, fn) -> "SolveReport":
        return dataclasses.replace(
            self, counters={k: fn(np.asarray(v))
                            for k, v in self.counters.items()})

    def take(self, idx) -> "SolveReport":
        idx = np.asarray(idx)
        return self._map(lambda a: a[idx])

    def slice(self, start: int, stop: int) -> "SolveReport":
        return self._map(lambda a: a[start:stop])

    @staticmethod
    def concat(parts: Sequence["SolveReport | None"]) -> "SolveReport | None":
        """Concatenate chunk reports along the batch axis.  Any ``None``
        part drops the whole report (same contract as ``WarmStart``)."""
        parts = list(parts)
        if not parts or any(p is None for p in parts):
            return None
        counters = {k: np.concatenate([np.asarray(p.counters[k])
                                       for p in parts])
                    for k in parts[0].counters}
        spans = tuple(s for p in parts for s in p.spans)
        return SolveReport(counters=counters, spans=spans,
                           wall_s=sum(p.wall_s for p in parts),
                           backend=parts[0].backend)

    # -- per-lane views -----------------------------------------------------

    def lane(self, name: str) -> np.ndarray:
        return np.asarray(self.counters[name])

    @property
    def iterations(self) -> np.ndarray:
        """Per-LP iteration counts (phase-1 + phase-2 lanes); equals
        ``LPResult.iterations`` exactly on every engine."""
        return self.lane("phase1_iters") + self.lane("phase2_iters")

    @property
    def pivots(self) -> np.ndarray:
        return self.lane("phase1_pivots") + self.lane("phase2_pivots")

    def total(self, name: str):
        return self.lane(name).sum().item()

    def percentiles(self, name: str, qs=(50, 90, 99)) -> dict:
        vals = self.lane(name).astype(np.float64)
        return {f"p{q:g}": float(np.percentile(vals, q)) for q in qs}

    def histogram(self, name: str, bins: int = 16):
        """(counts, edges) histogram of one lane across the batch."""
        counts, edges = np.histogram(self.lane(name).astype(np.float64),
                                     bins=bins)
        return counts, edges

    # -- aggregates ---------------------------------------------------------

    def summary(self) -> dict:
        """JSON-friendly batch aggregate: per-lane totals, mean, p50/p99 and
        max for every lane that is not identically zero, plus wall-clock and
        derived throughput."""
        B = self.batch_size
        lanes = {}
        for name in self.counters:
            vals = self.lane(name).astype(np.float64)
            if not np.any(vals):
                continue
            lanes[name] = {
                "total": float(vals.sum()), "mean": float(vals.mean()),
                "p50": float(np.percentile(vals, 50)),
                "p99": float(np.percentile(vals, 99)),
                "max": float(vals.max()),
            }
        out = {"batch_size": B, "backend": self.backend,
               "wall_s": self.wall_s, "lanes": lanes,
               "iterations_total": int(self.iterations.sum())}
        if self.wall_s > 0 and B:
            out["solves_per_sec"] = B / self.wall_s
        return out

    def render(self) -> str:
        """Human-readable multi-line summary table."""
        s = self.summary()
        lines = [f"SolveReport backend={s['backend'] or '?'} "
                 f"B={s['batch_size']} wall={s['wall_s']:.4f}s "
                 f"iters_total={s['iterations_total']}"]
        if "solves_per_sec" in s:
            lines[0] += f" solves/s={s['solves_per_sec']:.1f}"
        w = max((len(k) for k in s["lanes"]), default=0)
        for name, st in s["lanes"].items():
            lines.append(
                f"  {name:<{w}}  total={st['total']:>12g}  "
                f"mean={st['mean']:>10.2f}  p50={st['p50']:>8g}  "
                f"p99={st['p99']:>10g}  max={st['max']:>10g}")
        return "\n".join(lines)

    # -- exporters ----------------------------------------------------------

    def to_perfetto(self, path: str | None = None) -> dict:
        """Chrome/Perfetto trace-event JSON of the span tree."""
        return spans_to_perfetto(list(self.spans), path=path)

    def to_json(self, path: str | None = None) -> str:
        doc = {"summary": self.summary(),
               "spans": [s.to_dict() for s in self.spans]}
        text = json.dumps(doc, sort_keys=True)
        if path is not None:
            with open(path, "w") as fh:
                fh.write(text)
        return text


def report_from_counters(counters: dict, *, spans=(), wall_s: float = 0.0,
                         backend: str = "") -> SolveReport:
    """Build a report from host counter arrays (engine extraction path)."""
    return SolveReport(counters={k: np.asarray(v) for k, v in
                                 counters.items()},
                       spans=tuple(spans), wall_s=float(wall_s),
                       backend=backend)
