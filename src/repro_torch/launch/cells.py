"""(architecture x input-shape x mesh) cells of the dry run (the
reference's ``launch/cells.py``).

For each cell this builds one rank's share of the step: the model of the
config under the mesh's ``Sharder`` (each parameter the rank's block,
``Sharder.local_slices``), the step function (``distributed/steps.py``:
train, prefill or decode), and its arguments at the rank's local
shapes: the optimizer state of the config's optimizer (AdamW's moments
cut further by ZeRO-1), the batch's rows over the data axes under the
reference's ``_batch_axes`` guard, the VLM's patches and the encoder's
frames, the decode cache and its tokens and positions.  By default the
tensors are fake: on the meta device, with shapes and dtypes and no
data, so nothing is allocated (which is how a full config exists on a
host), and the mesh is abstract (``launch/mesh.py``
``make_production_mesh(abstract=True)``); given ``device`` they are
real, drawn from ``seed`` on that device, and the step runs.  A fake
cell's step runs under ``analysis/op_cost.py``'s counter, where a meta
tensor stands for a card tensor (``device.is_fake``).  The meta device
rather than ``FakeTensorMode``: a step traces about 2.6 times faster on
meta tensors (whisper-small's prefill_32k, one encoder and one decoder
layer: 38.7 s against 101 s on the host).

Where the reference shards the decode cache's sequence (``kv_seq``:
the padded KV heads do not divide the model axis), the port keeps every
row and the KV heads its query heads read; that and ``seq_sp`` on the
residual stream are the placements the port reports but does not
execute (``placement_gaps``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..configs import get_config
from ..distributed.sharding import Sharder
from ..distributed.steps import (make_decode_step, make_prefill_step,
                                 make_train_step)
from ..models import build_model, shape_by_name
from ..models.attention import KVCache
from ..models.config import ModelConfig, ShapeCell
from ..models.encdec import EncDecCache, EncDecLM
from ..models.layers import TensorSpec, torch_dtype
from ..models.mamba import MambaCache
from ..models.mla import MLACache
from ..models.transformer import LM, HymbaCache, map_cache
from ..optim import get_optimizer

FULL_ATTENTION_FAMILIES = ("dense", "moe", "vlm", "encdec")


def cell_is_skipped(cfg: ModelConfig, cell: ShapeCell) -> Optional[str]:
    if cell.name == "long_500k" and cfg.family in FULL_ATTENTION_FAMILIES:
        return ("skipped: 524k-token dense-KV decode is quadratic-cost for "
                "pure full-attention archs (per assignment, run only for "
                "SSM/hybrid)")
    return None


def _batch_axes(shd: Sharder, n: int):
    """The data axes that split a batch of ``n`` rows, None where they do
    not divide it (the reference's guard)."""
    if shd.mesh is None:
        return None
    dp = shd.dp_axes or None
    if dp is not None and n % shd._axis_size(dp) != 0:
        dp = None
    return dp


def local_rows(shd: Sharder, n: int) -> int:
    """This rank's rows of a batch of ``n``."""
    return n // shd._axis_size(_batch_axes(shd, n))


def _text_len(cfg: ModelConfig, S: int) -> int:
    return S - cfg.n_patches if cfg.family == "vlm" else S


def cache_logical_spec(cfg: ModelConfig):
    """The logical axes of each cache leaf (the reference's
    ``cache_logical_spec``)."""
    kv = KVCache(k=("layers", "batch", "kv_seq", "kv_heads", None),
                 v=("layers", "batch", "kv_seq", "kv_heads", None))
    if cfg.family == "encdec":
        return EncDecCache(
            self_kv=kv, cross_k=("layers", "batch", "kv_seq", "heads", None),
            cross_v=("layers", "batch", "kv_seq", "heads", None))
    if cfg.attn_kind == "mla":
        return MLACache(c_kv=("layers", "batch", "kv_seq", None),
                        k_rope=("layers", "batch", "kv_seq", None))
    ssm = MambaCache(h=("layers", "batch", "d_inner", None),
                     conv=("layers", "batch", None, "d_inner"))
    if cfg.family == "ssm":
        return ssm
    if cfg.family == "hybrid":
        return HymbaCache(kv=kv, ssm=ssm)
    return kv


def local_cache_shape(model, shd: Sharder, batch: int, seq: int):
    """The cache shapes of this rank's share of a decode over ``batch``
    sequences of ``seq`` rows: the batch's rows over the data axes (the
    guard), every dim whose logical axis the port executes sharded cut
    (``Sharder.placement``: KV heads, heads, ``d_inner``), the rest
    whole, ``kv_seq`` included (module docstring)."""
    whole = model.cache_shape(batch, seq)
    rows = local_rows(shd, batch)

    def one(spec: TensorSpec, logical):
        placement = shd.placement(logical, spec.shape)
        shape = []
        for n, ax, r in zip(spec.shape, logical, placement):
            if ax == "batch":
                shape.append(rows)
            else:
                shape.append(n // (shd._axis_size(r) if r else 1))
        return TensorSpec(tuple(shape), spec.dtype)

    return _zip_map(one, whole, cache_logical_spec(model.cfg))


def _zip_map(fn, specs, logical):
    if isinstance(specs, TensorSpec):
        return fn(specs, logical)
    return type(specs)(*(_zip_map(fn, s, lg) for s, lg in zip(specs,
                                                              logical)))


def placement_gaps(cfg: ModelConfig, shd: Sharder, cell: ShapeCell) -> list:
    """The reference's placements in this cell that the port reports but
    does not execute: ``seq_sp`` on the residual stream (train and
    prefill) and ``kv_seq`` in the decode cache."""
    gaps = []
    if shd.mesh is None:
        return gaps
    if cell.kind != "decode" and shd.rules.get("seq_sp") and \
            cell.seq_len % shd.tp == 0:
        gaps.append("seq_sp: the residual stream stays whole on every rank "
                    "of the model line (the reference shards its sequence "
                    f"{shd.tp} ways)")
    if cell.kind == "decode" and shd.rules.get("kv_seq") and \
            cfg.family != "ssm":
        gaps.append("kv_seq: the cache keeps every row and the KV heads "
                    "this rank's query heads read (the reference shards its "
                    f"rows {shd.tp} ways)")
    return gaps


@functools.lru_cache(maxsize=None)
def total_params(cfg: ModelConfig) -> int:
    """The whole model's parameter count, from the model built on the
    meta device (shapes only, no generator)."""
    cls = EncDecLM if cfg.family == "encdec" else LM
    model = cls(cfg, device=torch.device("meta"))
    return sum(p.numel() for p in model.parameters())


def _tensor(spec_shape, dtype, device, fill=0):
    return torch.full(spec_shape, fill, dtype=dtype, device=device)


def build_cell(arch: str, shape_name: str, mesh, *,
               cfg: Optional[ModelConfig] = None,
               microbatches: Optional[int] = None, device=None,
               seed: int = 0) -> dict:
    """{kind, fn, args, cfg, model, shd, total_params, placement_gaps} or
    {"skipped": reason, "cfg": cfg}.  ``fn(*args)`` runs this rank's
    step.  Without ``device`` every tensor is on the meta device (shapes
    and dtypes, no data: the kernel wrappers charge instead of launching,
    ``device.is_fake``); with one they are real, the parameters drawn
    from ``seed``.  ``total_params`` counts the whole model's parameters
    (``total_params``)."""
    cfg = cfg or get_config(arch)
    cell = shape_by_name(shape_name)
    skip = cell_is_skipped(cfg, cell)
    if skip:
        return {"skipped": skip, "cfg": cfg}
    shd = Sharder(cfg, mesh)
    if device is None:   # shapes only: no generator draws on meta
        dev = torch.device("meta")
        model = (EncDecLM if cfg.family == "encdec" else LM)(
            cfg, device=dev, shd=shd)
    else:
        dev = torch.device(device)
        model = build_model(cfg, device=dev, seed=seed, shd=shd)
    params = list(model.parameters())
    B, S = cell.global_batch, cell.seq_len
    rows = local_rows(shd, B)
    dtype = torch_dtype(cfg.dtype)
    out = {"kind": cell.kind, "cfg": cfg, "model": model, "shd": shd,
           "total_params": total_params(cfg),
           "placement_gaps": placement_gaps(cfg, shd, cell)}
    if cell.kind == "train":
        opt = get_optimizer(cfg.optimizer)
        opt_state = opt.init(list(model.named_parameters()), shd=shd)
        T = _text_len(cfg, S)
        batch = {"tokens": _tensor((rows, T), torch.long, dev),
                 "labels": _tensor((rows, T), torch.long, dev)}
        batch.update(_extra_inputs(cfg, rows, S, dtype, dev))
        mb = microbatches if microbatches is not None \
            else cfg.train_microbatches
        step = make_train_step(model, opt, microbatches=mb, shd=shd,
                               local_batch=True)
        out.update(fn=lambda params, state, batch: step(state, batch),
                   args=(params, opt_state, batch))
        return out
    if cell.kind == "prefill":
        tokens = _tensor((rows, _text_len(cfg, S)), torch.long, dev)
        extra = _extra_inputs(cfg, rows, S, dtype, dev) or None
        step = make_prefill_step(model)
        out.update(fn=_no_grad(lambda params, tokens, extra:
                               step(tokens, extra)),
                   args=(params, tokens, extra))
        return out
    # decode: one token against a full cache of S rows
    specs = local_cache_shape(model, shd, B, S)
    caches = map_cache(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                             device=dev), specs)
    cache_rows = S if cfg.family == "ssm" else \
        _first_kv(specs).shape[2]
    token = _tensor((rows,), torch.long, dev)
    pos = _tensor((rows,), torch.long, dev, fill=cache_rows - 1)
    step = make_decode_step(model)
    out.update(fn=_no_grad(lambda params, caches, token, pos:
                           step(caches, token, pos)),
               args=(params, caches, token, pos))
    return out


def _first_kv(specs) -> TensorSpec:
    """The first leaf that holds cache rows (self-attention K, or MLA's
    latent)."""
    if isinstance(specs, EncDecCache):
        return specs.self_kv.k
    if isinstance(specs, HymbaCache):
        return specs.kv.k
    return specs[0]


def _no_grad(fn):
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


def _extra_inputs(cfg: ModelConfig, rows: int, S: int, dtype, dev) -> dict:
    if cfg.family == "vlm":
        return {"patches": torch.zeros((rows, cfg.n_patches, cfg.d_model),
                                       dtype=dtype, device=dev)}
    if cfg.family == "encdec":
        return {"frames": torch.zeros((rows, S, cfg.d_model), dtype=dtype,
                                      device=dev)}
    return {}
