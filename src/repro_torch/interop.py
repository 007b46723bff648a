"""Carry problems, results and solver state across the two packages.

The system has no model weights: its state is the batch data and the
solver's results.  ``batch_from_reference`` turns a reference ``LPBatch`` or
``GeneralLPBatch`` into the port's, and ``result_arrays`` turns either
package's ``LPResult`` into a dict of NumPy arrays, so one input can be fed
to both packages and their outputs compared field by field.
``segment_state_from_tile`` turns the reference's segment-kernel state into
the port's ``CompactionState``, so one segment launch can be compared tile
by tile.  ``warm_from_reference`` and ``warm_to_reference`` carry a
``WarmStart`` (the solver state one solve hands the next) either way, so
one parent basis can seed both packages.  ``pdhg_state_from_reference``
turns the reference's PDHG state (engine or tile layout) into the port's
``PdhgState``, so one round or one segment launch runs from the same
state in both packages.  All of them read attributes only; nothing here
imports the reference package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.compaction import CompactionState
from .core.forms import GeneralLPBatch
from .core.lp import LPBatch, WarmStart
from .core.pdhg import PdhgState

RESULT_FIELDS = ("x", "objective", "status", "iterations", "y", "z")


def batch_from_reference(obj):
    """The port's ``GeneralLPBatch`` (when ``obj`` has row senses) or
    ``LPBatch`` with the same data."""
    if hasattr(obj, "sense"):
        kw = {f.name: getattr(obj, f.name)
              for f in dataclasses.fields(GeneralLPBatch)}
        return GeneralLPBatch(**kw)
    ub = getattr(obj, "ub", None)
    return LPBatch(A=np.asarray(obj.A), b=np.asarray(obj.b),
                   c=np.asarray(obj.c),
                   ub=None if ub is None else np.asarray(ub))


def result_arrays(res) -> dict:
    """``{field: numpy array or None}`` for the per-LP result fields."""
    return {f: None if getattr(res, f, None) is None
            else np.asarray(getattr(res, f)) for f in RESULT_FIELDS}


def _warm_fields(ws) -> dict:
    kw = {"m": int(ws.m), "n": int(ws.n), "pricing": ws.pricing}
    for f in WarmStart._ARRAY_FIELDS:
        v = getattr(ws, f, None)
        kw[f] = None if v is None else np.array(v)
    return kw


def warm_from_reference(ws):
    """The port's ``WarmStart`` with the leaves of a reference carrier
    (``None`` stays ``None``)."""
    return None if ws is None else WarmStart(**_warm_fields(ws))


def warm_to_reference(ws, cls):
    """A reference carrier of class ``cls`` (``repro.core.WarmStart``,
    which the caller imports) with the leaves of the port's ``ws``."""
    return None if ws is None else cls(**_warm_fields(ws))


def segment_state_from_tile(tile, *, m: int, n: int, stage: str,
                            device="cpu") -> CompactionState:
    """The port's unpadded segment state from the reference's one on the
    padded tile layout (``kernels.ops.PallasBackend``: rows padded to 8,
    lanes to 128, the rhs in the last padded lane, lane rows for weights,
    flips and bounds, (B, 1) scalars).  ``stage`` says which tableau ``T``
    holds: "p1" the full (m+2) x (n+2m+1) one, "p2" the compacted
    (m+1) x (n+m+1) one.  The reference carries no work counters: they
    start at zero."""
    rows, cols = (m + 2, n + 2 * m + 1) if stage == "p1" else (m + 1,
                                                                n + m + 1)
    T = np.asarray(tile.T)
    T = np.concatenate([T[:, :rows, :cols - 1], T[:, :rows, -1:]], axis=2)
    w = np.asarray(tile.w)
    if w.shape[1] > 1:
        w = w[:, :n + m]
    B = T.shape[0]

    def put(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype,
                               device=device)

    f32, i32 = torch.float32, torch.int32
    return CompactionState(
        T=put(T, f32), basis=put(np.asarray(tile.basis)[:, :m], i32),
        phase=put(np.asarray(tile.phase).reshape(-1), i32),
        status=put(np.asarray(tile.status).reshape(-1), i32),
        iters=put(np.asarray(tile.iters).reshape(-1), i32), w=put(w, f32),
        flip=put(np.asarray(tile.flip)[:, :n] != 0, torch.bool),
        ub=put(np.asarray(tile.ub)[:, :n], f32),
        thr=put(np.asarray(tile.thr).reshape(-1), f32),
        work=torch.zeros((B, 3), dtype=i32, device=device))


def pdhg_state_from_reference(ref, *, m: int, n: int, batch=None,
                              device="cpu") -> PdhgState:
    """The port's ``PdhgState`` with the leaves of a reference
    ``core.pdhg.PdhgState`` or of a ``kernels.pdhg_tile.PdhgTileState``
    (rows padded to 8, lanes to 128, the batch to a tile multiple, (B, 1)
    scalars; the padding is cut off, and the batch to its first ``batch``
    members when given).  Telemetry lanes are not carried."""
    B = np.asarray(ref.x).shape[0] if batch is None else int(batch)

    def put(name, cols=None, dtype=torch.float32, shape=None):
        a = np.asarray(getattr(ref, name))[:B]
        if cols is not None:
            a = a[:, :cols]
        a = a.reshape(B) if shape == "B" else a.reshape(B, -1) \
            if shape == "B1" else a
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    last = "last_res" if hasattr(ref, "last_res") else "last"
    prev = "prev_res" if hasattr(ref, "prev_res") else "prev"
    i32 = torch.int32
    return PdhgState(
        A=torch.as_tensor(np.array(np.asarray(ref.A)[:B, :m, :n]),
                          dtype=torch.float32, device=device),
        b=put("b", m), c=put("c", n), rsc=put("rsc", m), csc=put("csc", n),
        ub=put("ub", n), eta=put("eta", shape="B1"),
        omega=put("omega", shape="B1"), binf=put("binf", shape="B"),
        cinf=put("cinf", shape="B"), x=put("x", n), y=put("y", m),
        xs=put("xs", n), ys=put("ys", m), xr=put("xr", n), yr=put("yr", m),
        cnt=put("cnt", shape="B"), last_res=put(last, shape="B"),
        prev_res=put(prev, shape="B"), phase=put("phase", dtype=i32,
                                                 shape="B"),
        status=put("status", dtype=i32, shape="B"),
        iters=put("iters", dtype=i32, shape="B"))
