"""Attention (the reference's ``models/attention.py``): blockwise-causal GQA
with a sliding window, KV-cache decode and qk-norm, and the encoder-decoder's
cross-attention, in PyTorch.

Train and prefill attention is blockwise: a Python loop over query chunks,
and inside it a loop over only the kv chunks that chunk can see (the
reference's triangular schedule and its ``j_lo``/``j_hi``, the window
included), with an online softmax; the live score buffer is
(B, H, q_chunk, kv_chunk).  Decode attends one token against the whole
cache under a mask.  K and V are repeated to the query-head count,
kv-major (query head h reads kv head h // groups).

Numerics follow the reference's: its einsums take
``preferred_element_type=float32``, so here every product of two operands
widens them to float32 first (exact for bfloat16) and is reduced and
returned in float32 (with no TF32: ``launch.serve.set_matmul_policy``);
the softmax weights are cast to V's dtype before the PV product, and a
masked score is the finite ``NEG_INF``, so a kv chunk the window masks
whole for a row contributes exp(0) until the next chunk's ``alpha = 0``
wipes it, as in the reference (``-inf`` would give NaN).  These are torch
ops on the CPU and the card alike: the reference computes attention
outside any Pallas kernel.

With a sharder (``distributed/sharding.py``) a rank computes its block
of the heads: ``wq`` and ``wo`` on ``heads``, ``wk`` and ``wv`` on
``kv_heads``, the input entering the model line and the ``wo`` products
summed over it.  Where the heads are sharded and the KV heads are not
(their count does not divide the line), each rank projects every KV head
and takes the ones its query heads read (query head h reads h //
groups), not a contiguous 1/tp of them.  TP-padding heads are masked by
their global index.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..device import is_fake
from ..distributed.sharding import enter, gathered, line, reduce_over
from .config import ModelConfig
from .layers import TensorSpec, apply_rope, dense_init, torch_dtype

NEG_INF = -1e30


def _fit_chunk(S: int, c: int) -> int:
    """Largest chunk <= c that divides S."""
    c = max(1, min(c, S))
    while S % c:
        c -= 1
    return c


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with float32 products and sums, returned in float32."""
    return torch.einsum(eq, a.float(), b.float())


# ---------------------------------------------------------------------------
# core blockwise attention
# ---------------------------------------------------------------------------

def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, q_chunk: int, kv_chunk: int,
                        window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, dh); k/v: (B, Sk, H, dh) (already head-repeated).
    Returns (B, Sq, H, dh) in q's dtype.  Triangular chunk schedule,
    online softmax."""
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    qc = _fit_chunk(Sq, q_chunk)
    kc = _fit_chunk(Sk, kv_chunk)
    nq, nk = Sq // qc, Sk // kc
    rows = torch.arange(qc, device=q.device)
    cols = torch.arange(kc, device=q.device)

    outs = []
    for i in range(nq):
        qi = q[:, i * qc:(i + 1) * qc]                       # (B, qc, H, dh)
        q_pos = q_offset + i * qc + rows
        if causal:
            j_hi = min(nk, (q_offset + (i + 1) * qc + kc - 1) // kc)
        else:
            j_hi = nk
        j_lo = 0
        if window is not None:
            j_lo = max(0, (q_offset + i * qc - window) // kc)

        m = torch.full((B, H, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, qc, dh), dtype=torch.float32,
                          device=q.device)
        for j in range(j_lo, j_hi):
            kj = k[:, j * kc:(j + 1) * kc]
            vj = v[:, j * kc:(j + 1) * kc]
            s = _einsum_f32("bqhd,bkhd->bhqk", qi, kj) * scale
            k_pos = j * kc + cols
            mask = torch.ones((qc, kc), dtype=torch.bool, device=q.device)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (k_pos[None, :] > (q_pos[:, None] - window))
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + _einsum_f32(
                "bhqk,bkhd->bhqd", p.to(v.dtype), vj)
            m = m_new
        out_i = acc / torch.clamp(l[..., None], min=1e-20)
        outs.append(out_i.movedim(1, 2).to(q.dtype))        # (B, qc, H, dh)
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, H, dh); caches: (B, S, H, dh) (head-repeated).  Attends
    to cache positions <= pos (and > pos - window if sliding)."""
    B, S, H, dh = k_cache.shape
    scale = 1.0 / math.sqrt(dh)
    s = _einsum_f32("bqhd,bkhd->bhqk", q, k_cache) * scale
    k_pos = torch.arange(S, device=q.device)
    mask = k_pos[None, :] <= pos[:, None]                    # (B, S)
    if window is not None:
        mask = mask & (k_pos[None, :] > (pos[:, None] - window))
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = _einsum_f32("bhqk,bkhd->bhqd", p.to(v_cache.dtype), v_cache)
    out = out / torch.clamp(p.sum(dim=-1)[..., None], min=1e-20)
    return out.movedim(1, 2).to(q.dtype)                     # (B, 1, H, dh)


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, dh) -> (B, S, KV*groups, dh); heads ordered kv-major so
    query head h uses kv head h // groups."""
    if groups == 1:
        return k
    B, S, KV, dh = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, groups, dh) \
        .reshape(B, S, KV * groups, dh)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def gqa_init(gen, cfg: ModelConfig, device) -> dict:
    """wq (D, H dh), wk and wv (D, KV dh), wo (H dh, D), with H and KV
    the padded head counts where set; q_scale and k_scale (dh,) with
    qk-norm."""
    D, dh = cfg.d_model, cfg.d_head
    H = cfg.n_heads_padded or cfg.n_heads
    KV = cfg.n_kv_heads_padded or cfg.n_kv_heads
    dtype = torch_dtype(cfg.param_dtype)
    p = {"wq": dense_init(gen, D, H * dh, dtype, device),
         "wk": dense_init(gen, D, KV * dh, dtype, device),
         "wv": dense_init(gen, D, KV * dh, dtype, device),
         "wo": dense_init(gen, H * dh, D, dtype, device)}
    if cfg.qk_norm:
        p["q_scale"] = torch.ones(dh, dtype=dtype, device=device)
        p["k_scale"] = torch.ones(dh, dtype=dtype, device=device)
    return p


def _qk_normalize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMS norm over the head dimension in float32, cast back."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.float()).to(x.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S, KV, dh)
    v: torch.Tensor


def _check_rows(pos: torch.Tensor, rows: int):
    """Raise ``IndexError`` unless every position is a row of a cache of
    ``rows`` rows (the reference's ``dynamic_update_slice`` would clamp
    it and write the wrong row; a CUDA index past the end is a device
    fault, so the check reads the positions on the host: one
    synchronization a call).  Fake positions (the dry run's, which the
    reference's compiled decode does not check either) pass."""
    if is_fake(pos):
        return
    if bool(((pos < 0) | (pos >= rows)).any()):
        raise IndexError(f"decode position {pos.tolist()} outside the "
                         f"cache's {rows} rows")


def _zero_padding_heads(out: torch.Tensor, cfg: ModelConfig,
                        h0: int = 0) -> torch.Tensor:
    """out (B, S, H, dh), heads h0 .. h0 + H - 1 of the model's, with
    the heads past ``n_heads`` zeroed (the TP-padding heads,
    function-preserving)."""
    H = out.shape[2]
    if h0 + H <= cfg.n_heads:
        return out
    live = torch.arange(h0, h0 + H, device=out.device) < cfg.n_heads
    return out * live[None, None, :, None].to(out.dtype)


def head_blocks(p, cfg: ModelConfig, shd):
    """(the model line the heads are sharded over, the first global
    query head this rank computes, its query heads, its KV heads, the
    global index of its first KV head) for the GQA weights ``p``."""
    dh = cfg.d_head
    hl, kl = line(shd, "heads"), line(shd, "kv_heads")
    Hl, KVl = p["wq"].shape[1] // dh, p["wk"].shape[1] // dh
    return hl, hl.index * Hl, Hl, KVl, kl.index * KVl


def kv_for_heads(k: torch.Tensor, cfg: ModelConfig, h0: int, Hl: int,
                 kv0: int) -> torch.Tensor:
    """k (B, S, KVl, dh), KV heads kv0 .. kv0 + KVl - 1 of the model's,
    repeated to the Hl query heads from h0 (query head h reads KV head
    h // groups): ``repeat_kv`` where the blocks line up."""
    H = cfg.n_heads_padded or cfg.n_heads
    KV = cfg.n_kv_heads_padded or cfg.n_kv_heads
    groups = H // KV
    if Hl == k.shape[2] * groups and h0 == kv0 * groups:
        return repeat_kv(k, groups)
    idx = torch.arange(h0, h0 + Hl, device=k.device) // groups - kv0
    return k[:, :, idx]


def gqa_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, mode: str,
              cache: Optional[KVCache] = None,
              pos: Optional[torch.Tensor] = None, shd=None
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x: (B, S, D); positions: (B, S).  mode: "train" | "prefill" |
    "decode".  Prefill returns the filled cache (S rows); decode (S == 1)
    takes the cache and returns a new one with each sequence's K/V row
    written at its ``pos`` (B,); a position outside the cache raises.
    With ``shd``, this rank's heads (module docstring); the cache holds
    its KV heads."""
    B, S, D = x.shape
    dh = cfg.d_head
    p = gathered(shd, p, "attn")
    hl, h0, H, KV, kv0 = head_blocks(p, cfg, shd)
    x = enter(x, hl)

    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, KV, dh)
    v = (x @ p["wv"]).reshape(B, S, KV, dh)
    if cfg.qk_norm:
        q = _qk_normalize(q, p["q_scale"])
        k = _qk_normalize(k, p["k_scale"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and positions")
        if S != 1:
            raise ValueError(f"decode takes one token a sequence, got {S}")
        _check_rows(pos, cache.k.shape[1])
        at = (torch.arange(B, device=x.device), pos.long())
        k_cache = cache.k.index_put(at, k[:, 0])
        v_cache = cache.v.index_put(at, v[:, 0])
        new_cache = KVCache(k_cache, v_cache)
        out = decode_attention(
            q, kv_for_heads(k_cache, cfg, h0, H, kv0),
            kv_for_heads(v_cache, cfg, h0, H, kv0), pos,
            window=cfg.sliding_window)
    elif mode in ("train", "prefill"):
        out = blockwise_attention(
            q, kv_for_heads(k, cfg, h0, H, kv0),
            kv_for_heads(v, cfg, h0, H, kv0),
            causal=True, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
            window=cfg.sliding_window)
        if mode == "prefill":
            new_cache = KVCache(k, v)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = _zero_padding_heads(out, cfg, h0).reshape(B, S, H * dh)
    return reduce_over(out @ p["wo"], hl), new_cache


def gqa_cache_shape(cfg: ModelConfig, batch: int, seq: int) -> KVCache:
    """Per-layer cache shapes, the reference's: a sliding-window arch gets
    min(seq, window) rows.  Decode writes at the absolute position, so
    such a cache holds only the first ``window`` positions; the serving
    path does not use these shapes: it keeps all P + G rows (prefill's P,
    padded by ``launch.serve.pad_kv``)."""
    S = seq if cfg.sliding_window is None else min(seq, cfg.sliding_window)
    dt = torch_dtype(cfg.dtype)
    KV = cfg.n_kv_heads_padded or cfg.n_kv_heads
    return KVCache(k=TensorSpec((batch, S, KV, cfg.d_head), dt),
                   v=TensorSpec((batch, S, KV, cfg.d_head), dt))


# ---------------------------------------------------------------------------
# cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_attn_init(gen, cfg: ModelConfig, device) -> dict:
    """wq, wk, wv (D, H dh) and wo (H dh, D), H the padded head count
    where set: the encoder's K/V have as many heads as the queries."""
    D, dh = cfg.d_model, cfg.d_head
    H = cfg.n_heads_padded or cfg.n_heads
    dtype = torch_dtype(cfg.param_dtype)
    return {"wq": dense_init(gen, D, H * dh, dtype, device),
            "wk": dense_init(gen, D, H * dh, dtype, device),
            "wv": dense_init(gen, D, H * dh, dtype, device),
            "wo": dense_init(gen, H * dh, D, dtype, device)}


def cross_attn_apply(p, x: torch.Tensor, enc_kv, cfg: ModelConfig,
                     shd=None) -> torch.Tensor:
    """x: (B, S, D) decoder stream; enc_kv: (k, v) each (B, Senc, H, dh).
    A decode step (S == 1) attends through ``decode_attention`` at
    position Senc - 1, which sees every encoder row; prefill runs
    non-causal ``blockwise_attention``.  With ``shd``, this rank's block
    of the heads (and of enc_kv's, ``cross_kv``)."""
    B, S, D = x.shape
    dh = cfg.d_head
    p = gathered(shd, p, "xattn")
    hl = line(shd, "heads")
    H = p["wq"].shape[1] // dh
    x = enter(x, hl)
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k, v = enc_kv
    if S == 1:
        pos = torch.full((B,), k.shape[1] - 1, dtype=torch.long,
                         device=x.device)
        out = decode_attention(q, k, v, pos)
    else:
        out = blockwise_attention(q, k, v, causal=False,
                                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    out = _zero_padding_heads(out, cfg, hl.index * H)
    return reduce_over(out.reshape(B, S, H * dh) @ p["wo"], hl)


def cross_kv(p, enc_out: torch.Tensor, cfg: ModelConfig, shd=None):
    """The encoder output's cross-attention K and V, each
    (B, Senc, H, dh); with ``shd`` this rank's block of the heads."""
    B, Senc, D = enc_out.shape
    dh = cfg.d_head
    p = gathered(shd, p, "xattn")
    H = p["wk"].shape[1] // dh
    enc_out = enter(enc_out, line(shd, "heads"))
    k = (enc_out @ p["wk"]).reshape(B, Senc, H, dh)
    v = (enc_out @ p["wv"]).reshape(B, Senc, H, dh)
    return k, v
