"""Decoder-only LM assembly (the reference's ``models/transformer.py``),
for the ssm family: falcon-mamba.

``LM`` is an ``nn.Module`` with a ``ModuleList`` of blocks; the reference's
``lax.scan`` over stacked layers becomes a Python loop, and the caches it
returns are stacked on a leading layer axis as the reference's are.
Parameters keep the reference's names and (in, out) layouts and are frozen
(``requires_grad=False``): this slice serves, and training with its
backward scan kernel is the next one (ROADMAP queue 2 item 7).  The other
families (attention, MoE, MLA, hybrid, VLM) and ``loss_fn`` wait for their
slices (ROADMAP queue 1 item 15).
"""
from __future__ import annotations

import torch
from torch import nn

from .config import ModelConfig
from .layers import (apply_norm, embed_init, embed_lookup, head_init,
                     logits_apply, norm_init, torch_dtype)
from .mamba import MambaCache, TensorSpec, mamba_apply, mamba_cache_shape, \
    mamba_init


def _frozen(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


def check_ported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` unless ``cfg`` runs only modules the
    port has: a pure-SSM stack without MLPs."""
    if cfg.family != "ssm" or cfg.attn_kind != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP "
            "queue 1 item 15); the port runs the ssm family")
    if cfg.d_ff or cfg.mlp_kind == "moe":
        raise NotImplementedError(
            f"{cfg.name}: MLP blocks are not ported yet (ROADMAP queue 1 "
            "item 15)")


class Block(nn.Module):
    """One pre-norm residual block: x + mamba(norm1(x))."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _frozen(norm_init(cfg.d_model, cfg.norm_kind,
                                       torch_dtype(cfg.param_dtype), device))
        self.ssm = _frozen(mamba_init(gen, cfg, device))

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
        self.embed = _frozen(embed_init(gen, cfg, device))
        self.blocks = nn.ModuleList(Block(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _frozen(norm_init(cfg.d_model, cfg.norm_kind,
                                            torch_dtype(cfg.param_dtype),
                                            device))
        self.head = _frozen(head_init(gen, cfg, device))

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # -- embedding frontend ---------------------------------------------------
    def _embed_inputs(self, tokens):
        x = embed_lookup(self.embed, tokens)
        return x.to(torch_dtype(self.cfg.dtype))

    def _run_layers(self, x, *, mode, caches: MambaCache | None = None):
        new = []
        for i, block in enumerate(self.blocks):
            cache_l = None if caches is None else MambaCache(caches.h[i],
                                                             caches.conv[i])
            x, c = block(x, mode=mode, cache=cache_l)
            new.append(c)
        if mode == "train":
            return x, None
        return x, MambaCache(h=torch.stack([c.h for c in new]),
                             conv=torch.stack([c.conv for c in new]))

    def _logits(self, x):
        x = apply_norm(self.final_norm, x, self.cfg.norm_kind)
        head = self.head if len(self.head) else self.embed
        return logits_apply(head, x[:, -1:], self.cfg)[:, 0]

    # -- training loss --------------------------------------------------------
    def loss_fn(self, batch):
        raise NotImplementedError(
            "training is not ported yet: the next slice (ROADMAP queue 2 "
            "item 7) adds the backward scan kernel and the loss")

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
