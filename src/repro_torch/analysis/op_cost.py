"""The cost of one traced step: FLOPs, bytes, the peak of live bytes, an
op histogram, kernel charges and collectives (the counterpart of the
reference's ``analysis/hlo.py`` and ``analysis/hlo_cost.py``).

The reference compiles each step with XLA and reads the partitioned HLO
text: ``cost_analysis`` for FLOPs, its own trip-count-aware parser for
the bytes of every instruction inside ``while`` bodies, and the bytes of
each collective by text pattern.  The port runs eager PyTorch, so there
is no module to parse: ``OpCost`` is a ``TorchDispatchMode`` that sees
every aten op the step dispatches, usually over fake tensors (on the
meta device, as the dry run's cells build them), and records

* **flops** from ``torch.utils.flop_counter``'s formula registry: 2 M N K
  a product, batch dims included, and the convolutions;
* **bytes**: the inputs plus the outputs of every op that materializes
  memory.  Views, reshapes, ``expand``, ``detach``, ``as_strided`` and
  the ``empty`` allocations are free; an output that is an input (an
  in-place op) is counted once, as its input.  Every elementwise op
  counts, because the eager program launches each one: this is not
  ``hlo_cost.py``'s fusion-optimistic ``_MEM_OPS``, which leaves out the
  elementwise instructions a TPU fuses into its neighbours;
* **the peak of live bytes**: each storage an op's output creates is
  live from that op until the storage is freed (a ``weakref.finalize``
  on the storage), kept apart from the arguments' storages;
* **an aten-op histogram** (``hlo.py``'s ``op_histogram``);
* **kernel charges**: a kernel wrapper given fake inputs does not run;
  it returns fake outputs and ``charge``s one launch of the card's kernel
  (its operations and bytes, ``kernels/ssm_scan.py``,
  ``kernels/simplex_tile.py``).  A charge whose work depends on the data
  (the simplex kernel's pivots) is reckoned at ``default_trip`` trips;
* **the collectives**, by kind, from the records of the step's mesh
  (``distributed/sharding.py`` ``Mesh.exchanges``; an abstract mesh's
  lines exchange nothing), at max(operand, result) bytes as ``hlo.py``
  counts them.

What has no torch meaning: ``hlo.py``'s ``_shape_bytes`` and
``collective_stats``' text parsing (the ops and collectives are seen as
they run, with their tensors), ``hlo_cost.py``'s ``HloModule`` and its
trip-count products (an eager Python loop runs every trip, so each trip
is counted as it happens; ``default_trip`` is left only for charges whose
trip count depends on the data), and the async start/done pairs.
"""
from __future__ import annotations

import copy
import weakref
from collections import Counter
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# ops that move no bytes: views and aliases (``OpOverload.is_view``
# covers the rest) and allocations that write nothing
_FREE = {"detach", "alias", "_unsafe_view", "lift_fresh", "empty",
         "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_same_size", "_local_scalar_dense"}

_ACTIVE: list = []


def _tensors(tree) -> list:
    """The tensors in ``tree``; an op's arguments are flat lists of
    tensors and scalars, walked without the pytree machinery."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        out = []
        for x in tree:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple, dict)):
                out += _tensors(x)
        return out
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of the tensors in ``tree``
    (nested tuples, lists, dicts and NamedTuples)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        s = t.untyped_storage()
        if s._cdata not in seen:
            seen.add(s._cdata)
            total += s.nbytes()
    return total


class OpCost(TorchDispatchMode):
    """The counters of the module docstring over the ops dispatched while
    the mode is entered; ``arguments`` (a tree of tensors) are live
    before the step and are not counted in the peak."""

    def __init__(self, arguments=(), default_trip: float = 1.0):
        super().__init__()
        self.default_trip = float(default_trip)
        self.flops = 0.0
        self.mem_bytes = 0.0
        self.histogram: Counter = Counter()
        self.kernels: Dict[str, dict] = {}
        self.live = 0
        self.peak = 0
        self._args = {t.untyped_storage()._cdata for t in _tensors(arguments)}
        self._tracked: Dict[int, int] = {}

    # -- the counters ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":   # metadata queries (prim.device)
            return out
        packet = func.overloadpacket
        name = packet.__name__
        self.histogram[name] += 1
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        outs = _tensors(out)
        if not (func.is_view or name in _FREE):
            ins = _tensors(args)
            if kwargs:
                ins += _tensors(list(kwargs.values()))
            seen = {id(t) for t in ins}
            self.mem_bytes += sum(_bytes(t) for t in ins) + sum(
                _bytes(t) for t in outs if id(t) not in seen)
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor):
        s = t.untyped_storage()
        key = s._cdata
        if key in self._args or key in self._tracked:
            return
        n = s.nbytes()
        self._tracked[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int):
        self.live -= self._tracked.pop(key, 0)

    def _charge(self, name: str, flops: float, nbytes: float):
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.mem_bytes += nbytes

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)


def charge(name: str, *, flops: float = 0.0, nbytes: float = 0.0,
           trip_flops: float = 0.0):
    """One launch of the kernel ``name`` on fake inputs, charged to every
    ``OpCost`` being entered: ``flops`` and ``nbytes``, plus
    ``trip_flops`` a trip times the counter's ``default_trip`` (work
    whose trip count depends on the data).  A kernel wrapper calls it in
    place of its launch; with no counter entered a fake input is refused,
    as any device other than the CPU or a card is."""
    if not _ACTIVE:
        raise ValueError(f"{name} runs on cuda or cpu, not meta (no cost "
                         "counter is tracing)")
    for c in _ACTIVE:
        c._charge(name, flops + trip_flops * c.default_trip, nbytes)


def _collectives(mesh, before: dict) -> dict:
    """The collectives ``mesh``'s lines made since its kinds were
    ``before``, by kind and ``_total``."""
    after = mesh.exchanges()["kinds"] if mesh is not None else {}
    out = {}
    for kind, k in after.items():
        was = before.get(kind, {"count": 0, "bytes": 0})
        if k["count"] > was["count"]:
            out[kind] = {f: k[f] - was[f] for f in ("count", "bytes")}
    out["_total"] = {f: sum(v[f] for v in out.values())
                     for f in ("count", "bytes")}
    return out


def step_cost(fn: Callable, *args, default_trip: float = 1.0,
              arguments=None, mesh=None) -> dict:
    """Run ``fn(*args)`` under ``OpCost`` and return its counters:
    ``flops``, ``mem_bytes``, ``collectives`` (those of ``mesh``'s lines
    during the step, {kind: {count, bytes}} and ``_total``), ``kernels`` ({name: {launches, flops, bytes}}),
    ``argument_size_in_bytes`` (the distinct storages of ``args``, and of
    ``arguments`` where given: state the step reads that is not among
    its arguments, such as a model's parameters), ``output_size_in_bytes``
    (those of the result), ``temp_size_in_bytes`` (the peak of the bytes
    the step's ops created and held live at once, its outputs among
    them) and ``op_histogram`` (the aten ops by count, most first).
    Eager Python loops run every trip, so nothing is multiplied by a
    trip count; ``default_trip`` applies to data-dependent kernel
    charges only."""
    every = (args, arguments)
    before = copy.deepcopy(mesh.exchanges()["kinds"]) if mesh else {}
    with OpCost(every, default_trip) as cost:
        out = fn(*args)
        out_bytes = storage_bytes(out)
    return {"flops": cost.flops, "mem_bytes": cost.mem_bytes,
            "collectives": _collectives(mesh, before),
            "kernels": {k: dict(v) for k, v in cost.kernels.items()},
            "argument_size_in_bytes": storage_bytes(every),
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": cost.peak,
            "op_histogram": cost.histogram.most_common()}
