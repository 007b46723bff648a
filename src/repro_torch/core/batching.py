"""Batching routine: Algorithm 1 of the paper, sized against device memory.

Counterpart of ``repro.core.batching``.  The batch is canonicalized once,
optionally sorted by difficulty and padded to a power of two, cut into
chunks of at most ``N = floor(S / Y)`` LPs (Eq. 5: usable device bytes over
bytes per LP), each chunk is solved, and the results are concatenated,
unpadded and unpermuted.  On a card the budget is the card's memory and the
solver the CUDA kernels (kernels/ops.py); on the CPU it is a stated
constant and the plain PyTorch engine of the chosen backend
(core/simplex.py, core/revised.py, core/pdhg.py).  A warm-start carrier
follows the batch through the sort, the padding and the chunks: a basis
for the simplex engines, the iterates x, y and the primal weight omega
for pdhg.
"""
from __future__ import annotations

import inspect
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from .forms import ensure_canonical, finish_result, prepare_warm
from .lp import (LPBatch, LPResult, WarmStart, backend_spec,
                 canonicalize_backend, load_entry, resolve_backend)

# Planning budget for a CPU run (no device memory to size against).
CPU_DEVICE_BYTES = 16 * 2 ** 30
# Fraction of the budget the tableaux may claim (leave room for scratch).
BUDGET_FRACTION = 0.6


def device_bytes_of(device: torch.device) -> int:
    """Memory that chunking plans against: the card's total memory on
    cuda, ``CPU_DEVICE_BYTES`` on the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return CPU_DEVICE_BYTES


def max_chunk_size(batch: LPBatch, device_bytes: int = CPU_DEVICE_BYTES,
                   *, compaction: bool = False,
                   backend: str = "tableau") -> int:
    """Paper Eq. (5): N = floor(S / Y), with S = usable device bytes and Y
    the float32 bytes one LP needs on ``backend``'s path.  For the simplex
    engines Y is the tableau's; under the compaction scheduler
    (``compaction=True``) it counts two copies of the state: a survivor
    gather (at most a half-size bucket) and the one-shot phase compaction
    (a tableau two thirds the size or less) each copy it while the old one
    is still alive.  For pdhg Y is the setup's peak
    (``core.pdhg.pdhg_bytes_per_lp``), which covers the gathers."""
    usable = int(device_bytes * BUDGET_FRACTION)
    estimate = backend_spec(backend).bytes_per_lp
    if estimate is None:
        per_lp = (2 if compaction else 1) * batch.bytes_per_lp(4)
    else:
        per_lp = load_entry(estimate)(batch.m, batch.n)
    return max(1, usable // per_lp)


def difficulty_proxy(batch: LPBatch) -> np.ndarray:
    """Per-LP difficulty estimate for sorted batching: the count of
    infeasible rows (b_i < 0; each seeds an artificial that phase 1 must
    drive out), tie-broken by the relative infeasibility mass (a strictly
    sub-unit fraction, so it never reorders across counts)."""
    b = np.asarray(batch.b)
    neg = b < 0
    count = neg.sum(axis=1).astype(np.float64)
    mass = np.where(neg, -b, 0.0).sum(axis=1)
    frac = mass / (1.0 + mass.max()) if mass.max() > 0 else 0.0
    return count + frac


def _take_batch(batch: LPBatch, idx) -> LPBatch:
    return LPBatch(A=np.asarray(batch.A)[idx], b=np.asarray(batch.b)[idx],
                   c=np.asarray(batch.c)[idx],
                   ub=None if batch.ub is None else np.asarray(batch.ub)[idx])


def solve_batched(batch: LPBatch, *, solver: Optional[Callable] = None,
                  device=None, chunk_size: Optional[int] = None,
                  device_bytes: Optional[int] = None,
                  sort_by_difficulty: bool = False, pricing: str = "dantzig",
                  backend: str = "tableau", presolve: bool = True,
                  scale: Optional[bool] = None,
                  warm: Optional[WarmStart] = None,
                  pad_to_bucket: bool = False, compaction: bool = False,
                  **solver_kwargs) -> LPResult:
    """Chunked batched solve (Algorithm 1) on ``device`` (CUDA unless
    ``device="cpu"``; raises when neither is given nor available).

    With ``solver=None`` the solver is the CUDA kernels on cuda
    (``kernels.ops.solve_batched_kernel``, with ``backend=``) and the
    ``backend``'s plain engine on the CPU (``core/lp.py``
    ``BACKEND_REGISTRY``: ``solve_batched_torch``,
    ``solve_batched_revised`` or ``solve_batched_pdhg``, their scheduled
    forms with ``compaction``).  Engine options in ``solver_kwargs`` (for
    pdhg ``tol``, ``max_iters`` and ``step_rule``) reach the solver of
    every chunk; a custom ``solver`` takes the canonical sub-batch
    plus ``device=`` and, when asked for, ``pricing=``, ``backend=``,
    ``compaction=`` and ``warm=``.  ``sort_by_difficulty`` groups LPs of
    similar difficulty into the same chunk (results are unpermuted);
    ``pad_to_bucket`` pads the batch to a power of two by replicating
    members (the replicas' results are dropped).  ``warm``, a previous
    solve's ``LPResult.warm_start()``, is validated once, follows the
    sort and the padding, and is sliced per chunk; the chunks' captures
    are concatenated and unpermuted into the result's ``warm``.  A
    ``GeneralLPBatch`` is canonicalized once up front and the concatenated
    result recovered at the end."""
    canonicalize_backend(backend)
    dev = resolve_device(device)
    batch, rec = ensure_canonical(batch, presolve=presolve, scale=scale)
    warm = prepare_warm(warm, rec, batch)
    if solver is None:
        if dev.type == "cuda":
            from ..kernels.ops import solve_batched_kernel as solver
            solver_kwargs["backend"] = backend
            if compaction:
                solver_kwargs["compaction"] = True
        else:
            solver = resolve_backend(backend, compacted=compaction)
        solver_kwargs["pricing"] = pricing
    else:
        for kw, value, wanted in (("compaction", compaction, compaction),
                                  ("pricing", pricing, pricing != "dantzig"),
                                  ("backend", backend, backend != "tableau"),
                                  ("warm", warm, warm is not None)):
            if wanted and not _accepts(solver, kw):
                raise ValueError(
                    f"{kw}={value!r} requested but solver "
                    f"{getattr(solver, '__name__', solver)!r} does not "
                    f"accept a {kw!r} kwarg")
        if compaction:
            solver_kwargs["compaction"] = True
        if pricing != "dantzig":
            solver_kwargs.setdefault("pricing", pricing)
        if backend != "tableau":
            solver_kwargs.setdefault("backend", backend)
    solver_kwargs["device"] = dev

    def call(sub, sub_warm):
        # each chunk gets its own slice of the carrier
        if sub_warm is not None:
            return solver(sub, warm=sub_warm, **solver_kwargs)
        return solver(sub, **solver_kwargs)

    B = batch.batch
    perm = None
    if sort_by_difficulty and B > 1:
        perm = np.argsort(difficulty_proxy(batch), kind="stable")
        batch = _take_batch(batch, perm)
        warm = None if warm is None else warm.take(perm)
    unpad_B = None
    if pad_to_bucket and B > 1:
        Bp = 1 << (B - 1).bit_length()
        if Bp != B:
            idx = np.arange(Bp) % B
            batch = _take_batch(batch, idx)
            warm = None if warm is None else warm.take(idx)
            unpad_B, B = B, Bp

    if chunk_size is None:
        if device_bytes is None:
            device_bytes = device_bytes_of(dev)
        chunk_size = max_chunk_size(batch, device_bytes,
                                    compaction=compaction, backend=backend)
    if chunk_size >= B:
        res = call(batch, warm)
        return finish_result(rec, _unpermute(_unpad(res, unpad_B), perm))

    parts = []
    for i in range(math.ceil(B / chunk_size)):
        s, e = i * chunk_size, min((i + 1) * chunk_size, B)
        sub = LPBatch(A=batch.A[s:e], b=batch.b[s:e], c=batch.c[s:e],
                      ub=None if batch.ub is None else batch.ub[s:e])
        parts.append(call(sub, None if warm is None else warm.slice(s, e)))

    def cat(field):
        vals = [getattr(r, field) for r in parts]
        if any(v is None for v in vals):
            return None
        return np.concatenate([np.asarray(v) for v in vals])

    res = LPResult(x=cat("x"), objective=cat("objective"),
                   status=cat("status"), iterations=cat("iterations"),
                   y=cat("y"), z=cat("z"),
                   warm=WarmStart.concat([r.warm for r in parts]))
    return finish_result(rec, _unpermute(_unpad(res, unpad_B), perm))


def _accepts(solver: Callable, kw: str) -> bool:
    """Whether ``solver`` takes the keyword ``kw`` (or any keyword)."""
    params = inspect.signature(solver).parameters
    return kw in params or any(p.kind is inspect.Parameter.VAR_KEYWORD
                               for p in params.values())


def _map_result(res: LPResult, take, warm_fn) -> LPResult:
    return LPResult(x=take(res.x), objective=take(res.objective),
                    status=take(res.status), iterations=take(res.iterations),
                    y=take(res.y), z=take(res.z),
                    warm=None if res.warm is None else warm_fn(res.warm))


def _unpad(res: LPResult, B) -> LPResult:
    """Drop the pad_to_bucket replica rows (no-op when B is None)."""
    if B is None:
        return res
    return _map_result(res, lambda a: None if a is None else np.asarray(a)[:B],
                       lambda w: w.slice(0, B))


def _unpermute(res: LPResult, perm) -> LPResult:
    """Undo the difficulty sort (no-op when perm is None)."""
    if perm is None:
        return res
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return _map_result(res, lambda a: None if a is None else np.asarray(a)[inv],
                       lambda w: w.take(inv))
