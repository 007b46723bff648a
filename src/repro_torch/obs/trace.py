"""Host-side span tracer: nested wall-clock spans + structured event stream.

The tracer records the host-visible shape of a solve — canonicalize →
dispatch → segment k → bucket gather → recover — as a tree of ``Span``
objects with wall-clock bounds and arbitrary key/value args (lane
occupancy, bucket size, survivor counts).  Instantaneous events (an LP
retiring, a B&B node fathoming, a frontier admit) land in the same stream.

Two exporters:

* ``to_jsonl()`` — one JSON object per line, in completion order; the
  structured event stream that unifies ``SegmentStat`` logs and
  ``FrontierScheduler`` lifecycle events.
* ``to_perfetto()`` — Chrome/Perfetto trace-event JSON (``ph: "X"``
  complete events for spans, ``ph: "i"`` instants), loadable at
  https://ui.perfetto.dev or chrome://tracing.

Pure host/NumPy-free module: only ``time``/``json``/``dataclasses``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from contextlib import contextmanager
from typing import Any, Callable


@dataclasses.dataclass
class Span:
    """One timed region.  ``t0``/``t1`` are seconds on the tracer clock."""

    name: str
    t0: float
    t1: float = 0.0
    depth: int = 0
    args: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)

    @property
    def dur_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def to_dict(self) -> dict:
        return {
            "type": "span", "name": self.name, "t0": self.t0, "t1": self.t1,
            "dur_s": self.dur_s, "depth": self.depth, "args": dict(self.args),
            "children": [c.to_dict() for c in self.children],
            "events": [dict(e) for e in self.events],
        }

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


class SpanTracer:
    """Records a tree of nested spans plus instantaneous events."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._origin = clock()
        self._stack: list[Span] = []
        self.roots: list[Span] = []
        self.root_events: list[dict] = []  # events recorded with no open span
        self._log: list[dict] = []  # completion-order structured stream

    def _now(self) -> float:
        return self._clock() - self._origin

    @contextmanager
    def span(self, name: str, **args: Any):
        s = Span(name=name, t0=self._now(), depth=len(self._stack),
                 args=dict(args))
        (self._stack[-1].children if self._stack else self.roots).append(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            s.t1 = self._now()
            self._stack.pop()
            d = s.to_dict()
            d.pop("children")  # the stream is flat; nesting is via depth
            d.pop("events")
            self._log.append(d)

    def event(self, name: str, **args: Any) -> None:
        """Record an instantaneous event under the current span (or at the
        root when no span is open)."""
        e = {"type": "event", "name": name, "ts": self._now(),
             "depth": len(self._stack), "args": dict(args)}
        target = self._stack[-1].events if self._stack else self.root_events
        target.append({"name": name, "ts": e["ts"], "args": e["args"]})
        self._log.append(e)

    # -- exporters ----------------------------------------------------------

    def to_jsonl(self, path: str | None = None) -> str:
        """Structured event stream: one JSON object per line, in completion
        order (events when recorded, spans when closed)."""
        text = "\n".join(json.dumps(rec, sort_keys=True) for rec in self._log)
        if path is not None:
            with open(path, "w") as fh:
                fh.write(text + ("\n" if text else ""))
        return text

    def to_perfetto(self, path: str | None = None, *, pid: int = 1,
                    tid: int = 1) -> dict:
        return spans_to_perfetto(self.roots, path=path, pid=pid, tid=tid,
                                 extra_events=self.root_events)


def maybe_span(tracer, name: str, **args: Any):
    """``tracer.span(name, **args)`` when a tracer is attached, a context
    that records nothing otherwise: the solve paths trace when asked."""
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, **args)


def spans_to_perfetto(roots, path: str | None = None, *, pid: int = 1,
                      tid: int = 1, extra_events=()) -> dict:
    """Chrome trace-event JSON from a span tree (``ph:"X"`` complete events
    with microsecond timestamps; instants as ``ph:"i"``)."""
    trace_events = []
    for e in extra_events:
        trace_events.append({
            "name": e["name"], "ph": "i", "cat": "solve", "s": "t",
            "ts": round(e["ts"] * 1e6, 3), "pid": pid, "tid": tid,
            "args": _jsonable(e["args"]),
        })
    for root in roots:
        for s in root.walk():
            trace_events.append({
                "name": s.name, "ph": "X", "cat": "solve",
                "ts": round(s.t0 * 1e6, 3), "dur": round(s.dur_s * 1e6, 3),
                "pid": pid, "tid": tid, "args": _jsonable(s.args),
            })
            for e in s.events:
                trace_events.append({
                    "name": e["name"], "ph": "i", "cat": "solve", "s": "t",
                    "ts": round(e["ts"] * 1e6, 3), "pid": pid, "tid": tid,
                    "args": _jsonable(e["args"]),
                })
    doc = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as fh:
            json.dump(doc, fh)
    return doc


def _jsonable(args: dict) -> dict:
    out = {}
    for k, v in args.items():
        if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
            v = v.item()
        elif hasattr(v, "tolist"):
            v = v.tolist()
        out[k] = v
    return out
