"""Decoder-only LM assembly (the reference's ``models/transformer.py``),
for the ssm family: falcon-mamba.

``LM`` is an ``nn.Module`` with a ``ModuleList`` of blocks; the reference's
``lax.scan`` over stacked layers becomes a Python loop, and the caches it
returns are stacked on a leading layer axis as the reference's are.
Parameters keep the reference's names and (in, out) layouts and are
trainable; serving runs under ``torch.inference_mode()``.  ``loss_fn`` is
the reference's sequence-chunked cross entropy, and ``remat="block"``
checkpoints each block in train mode (``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint``), so the backward recomputes a block's
forward, scan kernel included.  The other families (attention, MoE, MLA,
hybrid, VLM) wait for their slices (ROADMAP: the rest of the LM
scaffold).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .layers import (apply_norm, embed_init, embed_lookup, head_init,
                     logits_apply, norm_init, token_nll, torch_dtype)
from .mamba import MambaCache, TensorSpec, mamba_apply, mamba_cache_shape, \
    mamba_init


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


def check_ported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` unless ``cfg`` runs only modules the
    port has: a pure-SSM stack without MLPs."""
    if cfg.family != "ssm" or cfg.attn_kind != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP: "
            "the rest of the LM scaffold); the port runs the ssm family")
    if cfg.d_ff or cfg.mlp_kind == "moe":
        raise NotImplementedError(
            f"{cfg.name}: MLP blocks are not ported yet (ROADMAP: the rest "
            "of the LM scaffold)")


class Block(nn.Module):
    """One pre-norm residual block: x + mamba(norm1(x))."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _params(norm_init(cfg.d_model, cfg.norm_kind,
                                       torch_dtype(cfg.param_dtype), device))
        self.ssm = _params(mamba_init(gen, cfg, device))

    def forward(self, x, *, mode: str, cache: MambaCache | None = None):
        h = apply_norm(self.norm1, x, self.cfg.norm_kind)
        a, new_cache = mamba_apply(self.ssm, h, self.cfg, mode=mode,
                                   cache=cache)
        return x + a, new_cache


class LM(nn.Module):
    """Decoder LM of the ssm family.  ``generator`` draws the parameters
    (embedding, blocks, head, in that order); ``None`` leaves them
    uninitialized for ``interop.lm_from_reference`` to fill."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        gen = generator
        self.embed = _params(embed_init(gen, cfg, device))
        self.blocks = nn.ModuleList(Block(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _params(norm_init(cfg.d_model, cfg.norm_kind,
                                            torch_dtype(cfg.param_dtype),
                                            device))
        self.head = _params(head_init(gen, cfg, device))

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # -- embedding frontend ---------------------------------------------------
    def _embed_inputs(self, tokens):
        x = embed_lookup(self.embed, tokens)
        return x.to(torch_dtype(self.cfg.dtype))

    def _run_layers(self, x, *, mode, caches: MambaCache | None = None):
        if mode == "train":
            for block in self.blocks:
                if self.cfg.remat == "block":
                    x, _ = checkpoint(block, x, mode=mode,
                                      use_reentrant=False)
                else:
                    x, _ = block(x, mode=mode)
            return x, None
        new = []
        for i, block in enumerate(self.blocks):
            cache_l = None if caches is None else MambaCache(caches.h[i],
                                                             caches.conv[i])
            x, c = block(x, mode=mode, cache=cache_l)
            new.append(c)
        return x, MambaCache(h=torch.stack([c.h for c in new]),
                             conv=torch.stack([c.conv for c in new]))

    def _head(self):
        return self.head if len(self.head) else self.embed

    def _logits(self, x):
        x = apply_norm(self.final_norm, x, self.cfg.norm_kind)
        return logits_apply(self._head(), x[:, -1:], self.cfg)[:, 0]

    # -- training loss --------------------------------------------------------
    def loss_fn(self, batch):
        """batch: {"tokens": (B, S) integer, "labels": (B, S) integer},
        tensors on the model's device.  Labels < 0 are masked.  Returns
        the mean next-token cross entropy (a float32 scalar)."""
        x = self._embed_inputs(batch["tokens"])
        x, _ = self._run_layers(x, mode="train")
        x = apply_norm(self.final_norm, x, self.cfg.norm_kind)
        return self._chunked_ce(x, batch["labels"])

    def _chunked_ce(self, x, labels, chunk: int = 1024):
        """Sequence-chunked cross entropy, so that the (S, vocab) logits
        never materialize at once."""
        S = x.shape[1]
        chunk = min(chunk, S)
        tot = x.new_zeros((), dtype=torch.float32)
        cnt = x.new_zeros((), dtype=torch.float32)
        for c0 in range(0, S, chunk):
            ls = labels[:, c0:c0 + chunk]
            logits = logits_apply(self._head(), x[:, c0:c0 + chunk],
                                  self.cfg)
            mask = ls >= 0
            tot = tot + (token_nll(logits, ls.clamp(min=0)) * mask).sum()
            cnt = cnt + mask.sum()
        return tot / cnt.clamp(min=1.0)

    # -- serving --------------------------------------------------------------
    def prefill(self, tokens):
        """tokens: (B, S) integer.  Returns (last-position logits
        (B, vocab_padded) float32, caches stacked on a layer axis)."""
        x = self._embed_inputs(tokens)
        x, caches = self._run_layers(x, mode="prefill")
        return self._logits(x), caches

    def decode_step(self, caches: MambaCache, token, pos):
        """token: (B,) integer; pos: (B,) write position (the ssm family
        keeps no positional state).  Returns (logits (B, vocab_padded),
        updated caches)."""
        x = self._embed_inputs(token[:, None])
        x, new_caches = self._run_layers(x, mode="decode", caches=caches)
        return self._logits(x), new_caches

    # -- cache shapes ---------------------------------------------------------
    def cache_shape(self, batch: int, seq: int) -> MambaCache:
        """Shapes of the stacked caches; the ssm family's do not grow with
        ``seq``."""
        L = self.cfg.n_layers
        return MambaCache(*(TensorSpec((L,) + s.shape, s.dtype)
                            for s in mamba_cache_shape(self.cfg, batch)))
