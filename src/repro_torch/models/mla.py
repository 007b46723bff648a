"""Multi-head Latent Attention (DeepSeek-V2) with a compressed KV cache
(the reference's ``models/mla.py``).

Train and prefill materialize per-head K/V from the ``kv_lora``-wide
latent and run them through ``blockwise_attention``; V's head dimension
is zero-padded from ``v_head_dim`` up to the query's (nope + rope) so the
shared kernel takes it, and the padding is cut from the output, as in
the reference.  Decode uses the absorbed form: ``W_UK`` folds into the
query and ``W_UV`` into the output path, so the scores contract against
the (B, S, kv_lora) latent cache and the (B, S, rope) shared positional
key, and no per-head K/V is built.

Decode keeps the reference's dtypes: the absorbed query in x's dtype,
both score products in float32, the softmax weights cast to the cache's
dtype before the PV product, and the mask ``arange(S) <= pos``.  It
writes each sequence's latent row at its ``pos`` and raises
``IndexError`` for a position outside the cache, as GQA decode does.

With a sharder a rank computes its block of the heads: ``wq_b``,
``wkv_b`` and ``wo`` on ``heads``; ``wq_a`` and ``wkv_a`` stay whole on
the model line (the reference's ``("residual", None)``), so the query
latent, the KV latent and the shared positional key enter the line
after them, and the ``wo`` products are summed over it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..distributed.sharding import enter, gathered, line, reduce_over
from .attention import NEG_INF, _check_rows, _einsum_f32, blockwise_attention
from .config import ModelConfig
from .layers import (TensorSpec, apply_norm, apply_rope, dense_init,
                     norm_init, torch_dtype)


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, S, kv_lora) compressed latents
    k_rope: torch.Tensor  # (B, S, rope_dim) shared positional key


def mla_init(gen, cfg: ModelConfig, device) -> dict:
    """wq_a (D, q_lora), q_norm, wq_b (q_lora, H (nope + rope)), wkv_a
    (D, kv_lora + rope), kv_norm, wkv_b (kv_lora, H (nope + v)) and wo
    (H v, D); the norms are RMSNorm scales."""
    D, H = cfg.d_model, cfg.n_heads
    qn, qr, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvl, ql = cfg.kv_lora, cfg.q_lora
    dtype = torch_dtype(cfg.param_dtype)
    return {"wq_a": dense_init(gen, D, ql, dtype, device),
            "q_norm": norm_init(ql, "rmsnorm", dtype, device),
            "wq_b": dense_init(gen, ql, H * (qn + qr), dtype, device),
            "wkv_a": dense_init(gen, D, kvl + qr, dtype, device),
            "kv_norm": norm_init(kvl, "rmsnorm", dtype, device),
            "wkv_b": dense_init(gen, kvl, H * (qn + vh), dtype, device),
            "wo": dense_init(gen, H * vh, D, dtype, device)}


def _project_q(p, x, cfg: ModelConfig, positions, hl):
    B, S, _ = x.shape
    qn, qr = cfg.qk_nope_dim, cfg.qk_rope_dim
    H = p["wq_b"].shape[1] // (qn + qr)
    q = enter(apply_norm(p["q_norm"], x @ p["wq_a"], "rmsnorm"), hl) \
        @ p["wq_b"]
    q = q.reshape(B, S, H, qn + qr)
    q_nope, q_pe = q[..., :qn], q[..., qn:]
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta)


def _latents(p, x, cfg: ModelConfig, positions, hl):
    kvl = cfg.kv_lora
    kv = x @ p["wkv_a"]                                     # (B, S, kvl+qr)
    c_kv = apply_norm(p["kv_norm"], kv[..., :kvl], "rmsnorm")
    k_pe = apply_rope(kv[..., kvl:], positions, cfg.rope_theta)  # (B, S, qr)
    return enter(c_kv, hl), enter(k_pe, hl)


def mla_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, mode: str,
              cache: Optional[MLACache] = None,
              pos: Optional[torch.Tensor] = None, shd=None
              ) -> Tuple[torch.Tensor, Optional[MLACache]]:
    """x: (B, S, D); positions: (B, S).  mode: "train" | "prefill" |
    "decode".  Prefill returns the latent cache of the S rows; decode
    (S == 1) takes it and returns a new one with each sequence's row
    written at its ``pos`` (B,).  With ``shd``, this rank's heads (module
    docstring)."""
    B, S, D = x.shape
    qn, qr, vh, kvl = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                       cfg.kv_lora)
    p = gathered(shd, p, "attn")
    hl = line(shd, "heads")
    H = p["wq_b"].shape[1] // (qn + qr)
    q_nope, q_pe = _project_q(p, x, cfg, positions, hl)
    wkv_b = p["wkv_b"].reshape(kvl, H, qn + vh)

    if mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and positions")
        if S != 1:
            raise ValueError(f"decode takes one token a sequence, got {S}")
        _check_rows(pos, cache.c_kv.shape[1])
        c_new, kpe_new = _latents(p, x, cfg, positions, hl)
        at = (torch.arange(B, device=x.device), pos.long())
        c_kv = cache.c_kv.index_put(at, c_new[:, 0])
        k_rope = cache.k_rope.index_put(at, kpe_new[:, 0])

        # absorbed attention: W_UK folds into q, W_UV into the output path
        w_uk, w_uv = wkv_b[..., :qn], wkv_b[..., qn:]
        q_lat = torch.einsum("bshn,khn->bshk", q_nope, w_uk)  # (B,1,H,kvl)
        s_lat = _einsum_f32("bshk,btk->bhst", q_lat, c_kv)
        s_pe = _einsum_f32("bshr,btr->bhst", q_pe, k_rope)
        scores = (s_lat + s_pe) / math.sqrt(float(qn + qr))
        mask = torch.arange(c_kv.shape[1], device=x.device)[None, :] \
            <= pos[:, None]
        scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhst,btk->bshk", probs.to(c_kv.dtype), c_kv)
        out = torch.einsum("bshk,khv->bshv", o_lat, w_uv)     # (B,1,H,vh)
        return reduce_over(out.reshape(B, S, H * vh) @ p["wo"], hl), \
            MLACache(c_kv, k_rope)
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")

    # train / prefill: materialized per-head K/V
    c_kv, k_pe = _latents(p, x, cfg, positions, hl)
    k_nope = torch.einsum("btk,khn->bthn", c_kv, wkv_b[..., :qn])
    v = torch.einsum("btk,khv->bthv", c_kv, wkv_b[..., qn:])
    k_pe_b = k_pe[:, :, None, :].expand(B, S, H, qr)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe_b], dim=-1)
    # v's head dim padded up to the qk dim for the shared blockwise kernel
    v = torch.nn.functional.pad(v, (0, qn + qr - vh))
    out = blockwise_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk)[..., :vh]
    out = reduce_over(out.reshape(B, S, H * vh) @ p["wo"], hl)
    return out, MLACache(c_kv, k_pe) if mode == "prefill" else None


def mla_cache_shape(cfg: ModelConfig, batch: int, seq: int) -> MLACache:
    dt = torch_dtype(cfg.dtype)
    return MLACache(c_kv=TensorSpec((batch, seq, cfg.kv_lora), dt),
                    k_rope=TensorSpec((batch, seq, cfg.qk_rope_dim), dt))
