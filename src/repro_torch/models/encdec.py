"""Whisper-style encoder-decoder (the reference's ``models/encdec.py``,
the whisper-small backbone).

The conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, D).  Encoder: bidirectional
self-attention and a GELU MLP over sinusoidal positions.  Decoder: causal
self-attention, cross-attention to the encoder's output and a GELU MLP,
over a learned table of 32,768 positions.  LayerNorm everywhere, no RoPE,
and the head tied to the embedding where the config ties them.

``EncDecLM`` is an ``nn.Module`` with the reference's parameter tree
(``embed``, ``pos_table``, ``enc_layers``, ``dec_layers``, ``enc_norm``,
``dec_norm``, ``head``); the reference's two ``lax.scan``s over stacked
layers become Python loops, and the caches come back stacked on a
leading layer axis.  Prefill computes each decoder layer's cross K/V from
the encoder's output once and keeps them in the cache; a decode step
reads them there and writes only its self-attention row.

With a sharder every group is this rank's block, as in ``LM``: the
self- and cross-attention heads and the MLP's ``ff`` tensor parallel,
the embedding and the tied head on the vocabulary, and under FSDP the
position table's ``residual`` columns gathered before use.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import is_fake
from ..distributed.sharding import (GatherLeaf, enter, gathered, line,
                                    reduce_over)
from .attention import (KVCache, _zero_padding_heads, blockwise_attention,
                        cross_attn_apply, cross_attn_init, cross_kv,
                        gqa_apply, gqa_cache_shape, gqa_init, head_blocks,
                        kv_for_heads)
from .config import ModelConfig
from .layers import (TensorSpec, apply_norm, embed_init, embed_lookup,
                     head_init, mlp_apply, mlp_init, normal_init, norm_init,
                     torch_dtype)
from .transformer import (_params, chunked_ce_sum, group_params, map_cache,
                          shard_group, whole_logits)

POS_TABLE_ROWS = 32768


class EncDecCache(NamedTuple):
    self_kv: KVCache            # (L, B, S_dec, KV, dh)
    cross_k: torch.Tensor       # (L, B, S_enc, H, dh)
    cross_v: torch.Tensor


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position embedding, (length, channels)
    float32: the sines of the first half, the cosines of the second.
    Computed in float64 on the host and rounded once, so the CPU and the
    card hold the same table; the reference computes it in float32, whose
    argument at row t is off by up to about t ulps of its frequency
    (1.2e-4 at the 1,500 frames of whisper-small's window)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length, dtype=np.float64)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(t), np.cos(t)], axis=1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


def _bidir_attn(p, x: torch.Tensor, cfg: ModelConfig,
                shd=None) -> torch.Tensor:
    """Non-causal self-attention (the encoder's) with GQA's weights;
    with ``shd`` this rank's heads, as ``gqa_apply``'s."""
    B, S, D = x.shape
    dh = cfg.d_head
    p = gathered(shd, p, "attn")
    hl, h0, H, KV, kv0 = head_blocks(p, cfg, shd)
    x = enter(x, hl)
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, KV, dh)
    v = (x @ p["wv"]).reshape(B, S, KV, dh)
    out = blockwise_attention(q, kv_for_heads(k, cfg, h0, H, kv0),
                              kv_for_heads(v, cfg, h0, H, kv0),
                              causal=False, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk)
    out = _zero_padding_heads(out, cfg, h0).reshape(B, S, H * dh)
    return reduce_over(out @ p["wo"], hl)


class EncBlock(nn.Module):
    """x + attn(norm1(x)), then x + mlp(norm2(x)); the decoder's block
    adds norm_x and the cross-attention between the two."""

    def __init__(self, cfg: ModelConfig, gen, device, shd=None):
        super().__init__()
        self.cfg = cfg
        self.shd = shd
        dtype = torch_dtype(cfg.param_dtype)
        self.norm1 = _params(norm_init(cfg.d_model, cfg.norm_kind, dtype,
                                       device))
        self.attn = group_params(gqa_init(gen, cfg, device), "attn", shd,
                                 cfg)
        self.norm2 = _params(norm_init(cfg.d_model, cfg.norm_kind, dtype,
                                       device))
        self.mlp = group_params(mlp_init(gen, cfg, device), "mlp", shd, cfg)

    def forward(self, x):
        cfg, shd = self.cfg, self.shd
        x = x + _bidir_attn(self.attn, apply_norm(self.norm1, x,
                                                  cfg.norm_kind), cfg, shd)
        return x + mlp_apply(self.mlp, apply_norm(self.norm2, x,
                                                  cfg.norm_kind), cfg, shd)


class DecBlock(EncBlock):
    """Causal self-attention, cross-attention, the MLP; each pre-norm
    and residual."""

    def __init__(self, cfg: ModelConfig, gen, device, shd=None):
        super().__init__(cfg, gen, device, shd)
        self.norm_x = _params(norm_init(cfg.d_model, cfg.norm_kind,
                                        torch_dtype(cfg.param_dtype),
                                        device))
        self.xattn = group_params(cross_attn_init(gen, cfg, device), "xattn",
                                  shd, cfg)

    def forward(self, x, enc_out=None, *, mode, positions, cache=None,
                pos=None):
        """Returns (x, this layer's ``EncDecCache`` slice, None in train
        mode).  Decode reads the cross K/V from ``cache``; train and
        prefill compute them from ``enc_out``."""
        cfg, shd = self.cfg, self.shd
        h = apply_norm(self.norm1, x, cfg.norm_kind)
        a, new_kv = gqa_apply(self.attn, h, cfg, positions=positions,
                              mode=mode,
                              cache=None if cache is None else cache.self_kv,
                              pos=pos, shd=shd)
        x = x + a
        hx = apply_norm(self.norm_x, x, cfg.norm_kind)
        if mode == "decode":
            ck, cv = cache.cross_k, cache.cross_v
        else:
            ck, cv = cross_kv(self.xattn, enc_out, cfg, shd)
        x = x + cross_attn_apply(self.xattn, hx, (ck, cv), cfg, shd)
        x = x + mlp_apply(self.mlp, apply_norm(self.norm2, x, cfg.norm_kind),
                          cfg, shd)
        return x, None if mode == "train" else EncDecCache(new_kv, ck, cv)


class EncDecLM(nn.Module):
    """The encoder-decoder LM of ``cfg`` (the encdec family), with the
    API of ``LM`` (``loss_fn``, ``prefill``, ``decode_step``,
    ``cache_shape``) plus ``encode``; its inputs add the frames.
    ``generator`` draws the parameters (embedding, position table,
    encoder, decoder, head, in that order); ``None`` leaves them
    uninitialized for ``interop.lm_from_reference`` to fill.  ``shd``
    makes the model this rank's, as ``LM``'s (module docstring)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None,
                 shd=None):
        super().__init__()
        self.shd = shd
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDecLM runs the encdec family, "
                             f"not {cfg.family}")
        self.cfg = cfg
        gen = generator
        dtype = torch_dtype(cfg.param_dtype)
        self.embed = group_params(embed_init(gen, cfg, device), "embed",
                                  shd, cfg)
        self.pos_table = nn.Parameter(shard_group(
            {"pos_table": normal_init(gen, (POS_TABLE_ROWS, cfg.d_model),
                                      0.01, dtype, device)}, "", shd,
            cfg)["pos_table"])
        self.enc_layers = nn.ModuleList(EncBlock(cfg, gen, device, shd)
                                        for _ in range(cfg.n_encoder_layers))
        self.dec_layers = nn.ModuleList(DecBlock(cfg, gen, device, shd)
                                        for _ in range(cfg.n_layers))
        self.enc_norm = _params(norm_init(cfg.d_model, cfg.norm_kind, dtype,
                                          device))
        self.dec_norm = _params(norm_init(cfg.d_model, cfg.norm_kind, dtype,
                                          device))
        self.head = group_params(head_init(gen, cfg, device), "head", shd,
                                 cfg)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def _remat(self, mode):
        return mode == "train" and self.cfg.remat == "block"

    # -- encoder --------------------------------------------------------------
    def encode(self, frames: torch.Tensor, *, mode: str = "prefill"):
        """frames: (B, S_enc, D) precomputed frame embeddings.  Returns
        the encoder's output (B, S_enc, D) in the config's dtype."""
        cfg = self.cfg
        if frames is None:
            raise ValueError("the encoder needs frames (B, S_enc, D)")
        S, D = frames.shape[1:]
        dtype = torch_dtype(cfg.dtype)
        x = frames.to(dtype) + sinusoids(S, D, frames.device).to(dtype)[None]
        for block in self.enc_layers:
            x = checkpoint(block, x, use_reentrant=False) \
                if self._remat(mode) else block(x)
        return apply_norm(self.enc_norm, x, cfg.norm_kind)

    # -- decoder --------------------------------------------------------------
    def _dec_embed(self, tokens):
        S = tokens.shape[1]
        if S > POS_TABLE_ROWS:
            raise ValueError(f"{S} tokens past the {POS_TABLE_ROWS}-row "
                             "position table")
        x = embed_lookup(self.embed, tokens, self.shd).to(
            torch_dtype(self.cfg.dtype))
        return x + self._pos_table()[:S][None].to(x.dtype)

    def _pos_table(self):
        """The whole position table: under FSDP this rank's columns
        gathered over the data line."""
        axis = line(self.shd, "residual")
        if axis.size == 1:
            return self.pos_table
        return GatherLeaf.apply(self.pos_table, axis, 1)

    def _dec_layers(self, x, enc_out, *, mode, positions, caches=None,
                    pos=None):
        new = []
        for i, block in enumerate(self.dec_layers):
            if self._remat(mode):
                x, c = checkpoint(block, x, enc_out, mode=mode,
                                  positions=positions, use_reentrant=False)
            else:
                cache_l = None if caches is None else \
                    map_cache(lambda t: t[i], caches)
                x, c = block(x, enc_out, mode=mode, positions=positions,
                             cache=cache_l, pos=pos)
            new.append(c)
        if mode == "train":
            return x, None
        return x, map_cache(lambda *ts: torch.stack(ts), *new)

    def _head(self):
        return self.head if len(self.head) else self.embed

    def _logits(self, x):
        x = apply_norm(self.dec_norm, x, self.cfg.norm_kind)
        return whole_logits(self._head(), x[:, -1:], self.cfg,
                            self.shd)[:, 0]

    @staticmethod
    def _positions(x):
        B, S = x.shape[:2]
        return torch.arange(S, device=x.device)[None].expand(B, S)

    # -- public API -----------------------------------------------------------
    def loss_fn(self, batch):
        """batch: {"frames": (B, S_enc, D), "tokens": (B, S) integer,
        "labels": (B, S) integer} on the model's device; labels < 0 are
        masked.  Returns the mean next-token cross entropy (float32)."""
        tot, cnt = self.loss_sum(batch)
        return tot / cnt.clamp(min=1.0)

    def loss_sum(self, batch):
        """``loss_fn``'s (sum, count) of the unmasked tokens' losses."""
        enc_out = self.encode(batch["frames"], mode="train")
        x = self._dec_embed(batch["tokens"])
        x, _ = self._dec_layers(x, enc_out, mode="train",
                                positions=self._positions(x))
        x = apply_norm(self.dec_norm, x, self.cfg.norm_kind)
        return chunked_ce_sum(self._head(), x, batch["labels"], self.cfg,
                              shd=self.shd)

    def prefill(self, tokens, frames=None):
        """tokens: (B, S) integer; frames: (B, S_enc, D).  Returns
        (last-position logits (B, vocab_padded) float32, the stacked
        ``EncDecCache``: S self-attention rows, S_enc cross rows)."""
        enc_out = self.encode(frames)
        x = self._dec_embed(tokens)
        x, caches = self._dec_layers(x, enc_out, mode="prefill",
                                     positions=self._positions(x))
        return self._logits(x), caches

    def decode_step(self, caches, token, pos):
        """token: (B,) integer; pos: (B,) the position each sequence
        writes and attends from (its self-attention row and its row of
        the position table).  Returns (logits (B, vocab_padded), updated
        caches).  A position outside the table raises (a fake one, the
        dry run's, is not checked)."""
        if not is_fake(pos) and \
                bool(((pos < 0) | (pos >= POS_TABLE_ROWS)).any()):
            raise IndexError(f"decode position {pos.tolist()} outside the "
                             f"{POS_TABLE_ROWS}-row position table")
        x = (embed_lookup(self.embed, token, self.shd)
             + self._pos_table()[pos.long()])
        x = x[:, None].to(torch_dtype(self.cfg.dtype))
        x, new_caches = self._dec_layers(x, None, mode="decode",
                                         positions=pos[:, None],
                                         caches=caches, pos=pos)
        return self._logits(x), new_caches

    def cache_shape(self, batch: int, seq: int,
                    enc_seq: Optional[int] = None) -> EncDecCache:
        """Shapes of the stacked caches, the reference's: ``seq``
        self-attention rows (``gqa_cache_shape``'s) and ``enc_seq``
        (default ``seq``) cross rows of the padded head count."""
        cfg = self.cfg
        L = cfg.n_layers
        enc_seq = enc_seq or seq
        dt = torch_dtype(cfg.dtype)
        kv = gqa_cache_shape(cfg, batch, seq)
        H = cfg.n_heads_padded or cfg.n_heads
        cross = TensorSpec((L, batch, enc_seq, H, cfg.d_head), dt)
        return EncDecCache(
            self_kv=map_cache(lambda s: TensorSpec((L,) + s.shape, s.dtype),
                              kv),
            cross_k=cross, cross_v=cross)
