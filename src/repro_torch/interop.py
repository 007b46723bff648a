"""Carry problems, results and solver state across the two packages.

The system has no model weights: its state is the batch data and the
solver's results.  ``batch_from_reference`` turns a reference ``LPBatch`` or
``GeneralLPBatch`` into the port's, and ``result_arrays`` turns either
package's ``LPResult`` into a dict of NumPy arrays, so one input can be fed
to both packages and their outputs compared field by field.
``general_from_reference`` carries a ``GeneralLPBatch`` alone, its
integer mask included, so one MIP feeds both packages' branch-and-bound.
``segment_state_from_tile`` turns the reference's segment-kernel state into
the port's ``CompactionState``, so one segment launch can be compared tile
by tile, and ``compaction_state_from_reference`` the reference's
full-tableau scheduler state, so one combined segment runs from the same
state in both packages; ``revised_state_from_tile`` does the same for the
revised kernel's state.  Each carries the reference state's telemetry lanes when
it has them (``tel_from_reference``), so a port segment can start from the
reference's mid-solve counters.  ``warm_from_reference`` and ``warm_to_reference`` carry a
``WarmStart`` (the solver state one solve hands the next) either way, so
one parent basis can seed both packages.  ``pdhg_state_from_reference``
turns the reference's PDHG state (engine or tile layout) into the port's
``PdhgState``, so one round or one segment launch runs from the same
state in both packages.  ``lm_from_reference`` turns the reference model's
parameter tree (an LM's, MLA blocks included, or the encoder-decoder's)
into the port's ``LM`` or ``EncDecLM``, so both compute the same
function; ``lm_to_reference`` is its inverse, for parameters and for
gradients.
All of them read attributes only; nothing here imports the reference
package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.compaction import CompactionState
from .core.forms import GeneralLPBatch
from .core.lp import LPBatch, WarmStart
from .core.pdhg import PdhgState
from .core.revised import WORK_FIELDS, RevisedState
from .models.transformer import LM
from .obs.telemetry import ALL_LANES, INT_LANES, TelemetryState

RESULT_FIELDS = ("x", "objective", "status", "iterations", "y", "z")


def general_from_reference(g) -> GeneralLPBatch:
    """The port's ``GeneralLPBatch`` with every field of a reference one:
    the data, the row structure, the names and the integer mask."""
    kw = {f.name: getattr(g, f.name)
          for f in dataclasses.fields(GeneralLPBatch)}
    return GeneralLPBatch(**kw)


def batch_from_reference(obj):
    """The port's ``GeneralLPBatch`` (when ``obj`` has row senses) or
    ``LPBatch`` with the same data."""
    if hasattr(obj, "sense"):
        return general_from_reference(obj)
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


def tel_from_reference(tel, *, batch=None, device="cpu"):
    """The port's ``TelemetryState`` with the lanes of a reference
    ``obs.telemetry.TelemetryState`` (cut to its first ``batch`` members
    when given); ``None`` stays ``None``."""
    if tel is None:
        return None

    def put(name):
        a = np.asarray(getattr(tel, name)).reshape(-1)
        if batch is not None:
            a = a[:int(batch)]
        dtype = torch.int32 if name in INT_LANES else torch.float32
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return TelemetryState(**{name: put(name) for name in ALL_LANES})


def segment_state_from_tile(tile, *, m: int, n: int, stage: str,
                            device="cpu") -> CompactionState:
    """The port's unpadded segment state from the reference's one on the
    padded tile layout (``kernels.ops.PallasBackend``: rows padded to 8,
    lanes to 128, the rhs in the last padded lane, lane rows for weights,
    flips and bounds, (B, 1) scalars).  ``stage`` says which tableau ``T``
    holds: "p1" the full (m+2) x (n+2m+1) one, "p2" the compacted
    (m+1) x (n+m+1) one.  The reference carries no work counters: they
    start at zero.  Its telemetry lanes, when it has them, come along."""
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
        work=torch.zeros((B, 3), dtype=i32, device=device),
        tel=tel_from_reference(getattr(tile, "tel", None), batch=B,
                               device=device))


def compaction_state_from_reference(ref, *, m: int, n: int,
                                    device="cpu") -> CompactionState:
    """The port's ``CompactionState`` from the reference's one on the full
    (m+2) x (n+2m+1) tableau (``repro.core.compaction.JaxBackend``, the
    frontier scheduler's layout): the same leaves, the weights cut to the
    n+m priceable columns (a (B, 1) stub stays one), zero work counters
    (the reference keeps none) and its telemetry lanes when it has
    them."""
    T = np.asarray(ref.T)
    B = T.shape[0]
    if T.shape[1:] != (m + 2, n + 2 * m + 1):
        raise ValueError(f"T has shape {T.shape}, expected the full "
                         f"({B}, {m + 2}, {n + 2 * m + 1}) tableau")
    w = np.asarray(ref.w)
    if w.shape[1] > 1:
        w = w[:, :n + m]

    def put(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    return CompactionState(
        T=put(T, f32), basis=put(ref.basis, i32),
        phase=put(np.asarray(ref.phase).reshape(-1), i32),
        status=put(np.asarray(ref.status).reshape(-1), i32),
        iters=put(np.asarray(ref.iters).reshape(-1), i32), w=put(w, f32),
        flip=put(np.asarray(ref.flip) != 0, torch.bool),
        ub=put(ref.ub, f32), thr=put(np.asarray(ref.thr).reshape(-1), f32),
        work=torch.zeros((B, 3), dtype=i32, device=device),
        tel=tel_from_reference(getattr(ref, "tel", None), batch=B,
                               device=device))


def revised_state_from_tile(tile, *, m: int, n: int, batch=None,
                            device="cpu") -> RevisedState:
    """The port's ``RevisedState`` from the reference revised kernel's
    state on the padded tile layout (``kernels.revised_tile
    .RevisedTileState``: rows padded to 8, lanes to 128, the batch to a
    tile multiple, (B, 1) scalars), cut to its first ``batch`` members when
    given.  The basis inverse stays behind (the port's segment factorizes
    its own at its first step); ``y`` and the work counters start at
    zero; the telemetry lanes, when it has them, come along."""
    B = np.asarray(tile.xB).shape[0] if batch is None else int(batch)

    def put(name, cols=None, dtype=torch.float32):
        a = np.asarray(getattr(tile, name))[:B]
        a = a[:, :cols] if cols is not None else a.reshape(B)
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    return RevisedState(
        Abar=torch.as_tensor(np.array(np.asarray(tile.Abar)[:B, :m,
                                                            :n + 2 * m]),
                             dtype=f32, device=device),
        cvec=put("cvec", n + m), ub=put("ub", n), thr=put("thr"),
        xB=put("xB", m), basis=put("basis", m, i32),
        onub=put("onub", n, torch.bool), phase=put("phase", dtype=i32),
        status=put("status", dtype=i32), iters=put("iters", dtype=i32),
        y=torch.zeros((B, m), dtype=f32, device=device),
        work=torch.zeros((B, len(WORK_FIELDS)), dtype=i32, device=device),
        tel=tel_from_reference(getattr(tile, "tel", None), batch=B,
                               device=device))


def pdhg_state_from_reference(ref, *, m: int, n: int, batch=None,
                              device="cpu") -> PdhgState:
    """The port's ``PdhgState`` with the leaves of a reference
    ``core.pdhg.PdhgState`` or of a ``kernels.pdhg_tile.PdhgTileState``
    (rows padded to 8, lanes to 128, the batch to a tile multiple, (B, 1)
    scalars; the padding is cut off, and the batch to its first ``batch``
    members when given).  Its telemetry lanes, when it has them, come
    along."""
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
        iters=put("iters", dtype=i32, shape="B"),
        tel=tel_from_reference(getattr(ref, "tel", None), batch=B,
                               device=device))


# the port's layer lists and the reference's stacked groups they hold
STACKS = {"blocks": "layers", "enc_layers": "enc_layers",
          "dec_layers": "dec_layers"}


def _port_model(cfg, device, shd=None):
    from .models.encdec import EncDecLM
    cls = EncDecLM if cfg.family == "encdec" else LM
    return cls(cfg, device=torch.device(device), shd=shd)


def _flat_reference(tree, model) -> dict:
    """``{port parameter name: array}`` of a reference parameter tree:
    nested dicts joined with dots, and each stacked group's leaves split
    along axis 0 into the port's layer list (``layers`` to
    ``blocks.<i>``, ``enc_layers`` and ``dec_layers`` to themselves)."""
    def walk(node, prefix):
        if not isinstance(node, dict):
            yield prefix[:-1], node
            return
        for k, v in node.items():
            yield from walk(v, f"{prefix}{k}.")

    ref_to_port = {ref: port for port, ref in STACKS.items()
                   if hasattr(model, port)}
    out = {}
    for top, node in tree.items():
        if top not in ref_to_port:
            out.update(walk(node, f"{top}."))
            continue
        for rest, a in walk(node, ""):
            a = np.asarray(a)
            for i in range(a.shape[0]):
                out[f"{ref_to_port[top]}.{i}.{rest}"] = a[i]
    return out


def lm_from_reference(cfg, params_np, device="cpu", shd=None):
    """The port's model of ``cfg`` on ``device`` (``EncDecLM`` for the
    encdec family, ``LM`` for every other) with the reference model's
    parameters: ``params_np`` is ``jax.tree.map(np.asarray, params)`` of
    the reference's ``build_model(cfg).init(key)[0]``, layers stacked on
    axis 0; every layer group (``norm1``, ``attn``, ``ssm``, ``norm2``,
    ``mlp``, the decoder's ``norm_x`` and ``xattn``, MLA's nested norms)
    and the encdec tree's ``pos_table`` included.  Both keep weights as
    (in, out), so each leaf is a copy (through float32, which holds
    bfloat16 exactly), its shape checked.  With ``shd`` (a
    ``distributed.sharding.Sharder``) the model is this rank's: each
    leaf is cut to the slice the rank holds (``Sharder.local_slices``)."""
    from .distributed.sharding import param_spec
    model = _port_model(cfg, device, shd)
    src = _flat_reference(params_np, model)
    if shd is not None:
        src = {k: np.asarray(v)[shd.local_slices(param_spec(k, cfg),
                                                 np.shape(v))]
               for k, v in src.items()}
    dst = dict(model.named_parameters())
    if set(src) != set(dst):
        raise ValueError(f"reference leaves {sorted(set(src) - set(dst))} "
                         f"differ from the port's "
                         f"{sorted(set(dst) - set(src))}")
    with torch.no_grad():
        for name, p in dst.items():
            a = torch.from_numpy(np.array(src[name], dtype=np.float32))
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"reference leaf {name} has shape "
                                 f"{tuple(a.shape)}, the port's "
                                 f"{tuple(p.shape)}")
            p.copy_(a)
    return model


def lm_to_reference(model, tensors=None) -> dict:
    """The reference model's NumPy parameter tree (layers stacked on axis
    0) with the port's ``model`` parameters (an ``LM`` or an
    ``EncDecLM``), or with ``tensors``, a list that matches
    ``model.parameters()`` (the gradients of a step, say): the inverse of
    ``lm_from_reference``.  bfloat16 leaves come back as float32, which
    holds them exactly."""
    names = [name for name, _ in model.named_parameters()]
    values = list(model.parameters()) if tensors is None else list(tensors)
    if len(values) != len(names):
        raise ValueError(f"{len(values)} tensors for {len(names)} "
                         "parameters")

    def numpy(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    # every top-level group, the empty ones (a tied head, no layers) too
    tree = {STACKS.get(name, name): {} for name, _ in model.named_children()}
    stacked = {}
    for name, t in zip(names, values):
        top, *rest = name.split(".")
        if top in STACKS:
            i, *rest = rest
            stacked.setdefault((STACKS[top], *rest), {})[int(i)] = numpy(t)
            continue
        if not rest:
            tree[top] = numpy(t)
            continue
        node = tree[top]
        for k in rest[:-1]:
            node = node.setdefault(k, {})
        node[rest[-1]] = numpy(t)
    for (top, *rest), layers in stacked.items():
        node = tree[top]
        for k in rest[:-1]:
            node = node.setdefault(k, {})
        node[rest[-1]] = np.stack([layers[i] for i in sorted(layers)])
    return tree
