"""Shared layers of the port's LM: parameter inits, norms, embedding and
logits (the reference's ``models/layers.py``).

Inits draw from an explicit ``torch.Generator`` at the reference's scales
and dtypes: a normal sample in float32, scaled, then cast to the parameter
dtype.  The two frameworks give different numbers from one seed, so tests
carry the reference's parameters over with ``interop.lm_from_reference``;
with ``gen=None`` an init allocates its tensor uninitialized for that.
Weights keep the reference's (in, out) layout, so ``x @ w`` is the
reference's product.  The MLPs (SwiGLU, squared ReLU, tanh-approximate
GELU) and RoPE, which rotates the two halves of the head dimension in
float32, follow the reference op by op.

With a sharder (``distributed/sharding.py``) each function computes on
this rank's blocks: ``mlp_apply`` column-parallel on ``ff`` and
row-parallel back, ``embed_lookup`` and ``vocab_nll`` on this rank's
rows of the vocabulary, FSDP's leaves gathered over the data line
before use.  Without one they are the one-device functions, bit for
bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import (VocabNLL, enter, gathered, line,
                                    reduce_over)
from .config import ModelConfig


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor (the port's ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def torch_dtype(name: str) -> torch.dtype:
    """``torch.bfloat16`` for "bfloat16" and so on."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def normal_init(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    """``normal(shape) * scale`` drawn in float32 from ``gen``, cast to
    ``dtype``; uninitialized when ``gen`` is None."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# param init helpers
# ---------------------------------------------------------------------------

def dense_init(gen, in_dim: int, out_dim: int, dtype, device) -> torch.Tensor:
    """An (in_dim, out_dim) weight with entries N(0, 1/in_dim)."""
    return normal_init(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim), dtype,
                       device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(d: int, kind: str, dtype, device) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device)}
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6):
    """RMSNorm or LayerNorm over the last axis in float32, cast back to
    ``x``'s dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float() \
            + p["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs (SwiGLU / squared-ReLU / GELU)
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg: ModelConfig, device, d_ff: int | None = None) -> dict:
    """SwiGLU: w_gate, w_up (D, F) and w_down (F, D); every other kind:
    w_in (D, F) and w_down (F, D)."""
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    dtype = torch_dtype(cfg.param_dtype)
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": dense_init(gen, D, F_, dtype, device),
                "w_up": dense_init(gen, D, F_, dtype, device),
                "w_down": dense_init(gen, F_, D, dtype, device)}
    return {"w_in": dense_init(gen, D, F_, dtype, device),
            "w_down": dense_init(gen, F_, D, dtype, device)}


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig, shd=None
              ) -> torch.Tensor:
    """x: (..., D) -> (..., D) in x's dtype.  Any kind but swiglu and relu2
    is the tanh-approximate GELU, as in the reference.  With ``shd`` the
    hidden units are this rank's ``ff`` block: x enters the model line,
    and the row-parallel ``w_down`` products are summed over it."""
    ff = line(shd, "ff")
    p = gathered(shd, p, "mlp")
    x = enter(x, ff)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.mlp_kind == "relu2":  # nemotron-4 squared ReLU
        h = F.relu(x @ p["w_in"]).square()
    else:  # gelu (whisper); jax.nn.gelu(approximate=True)
        h = F.gelu(x @ p["w_in"], approximate="tanh")
    return reduce_over(h @ p["w_down"], ff)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(d: int, theta: float, device=None) -> torch.Tensor:
    """(d/2,) float32 inverse frequencies theta^(-2i/d)."""
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=device) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, d_head) or (..., S, d); positions: (..., S).  Rotates
    the two halves of the last axis (not interleaved pairs) in float32 and
    casts back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)             # (d/2,)
    angles = positions[..., None].float() * freqs            # (..., S, d/2)
    if x.dim() == angles.dim() + 1:                          # head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings & logits
# ---------------------------------------------------------------------------

def embed_init(gen, cfg: ModelConfig, device) -> dict:
    shape = (cfg.vocab_padded, cfg.d_model)
    return {"table": normal_init(gen, shape, 0.01,
                                 torch_dtype(cfg.param_dtype), device)}


def embed_lookup(p, tokens: torch.Tensor, shd=None) -> torch.Tensor:
    """The table's rows of ``tokens``.  With ``shd`` the table is this
    rank's block of the ``vocab`` rows: ids outside it read zero, and
    the rows are summed over the model line (each id is one rank's)."""
    table = gathered(shd, p, "embed")["table"]
    vl = line(shd, "vocab")
    if vl.size == 1:
        return table[tokens]
    n = table.shape[0]
    local = tokens - vl.index * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return reduce_over(torch.where(inside[..., None], rows,
                                   rows.new_zeros(())), vl)


def logits_apply(p_head, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (..., D) -> (..., vocab_padded) float32 with padded entries
    masked to -1e9."""
    logits = x @ p_head["table"].T if "table" in p_head else x @ p_head["w"]
    logits = logits.float()
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e9)
    return logits


def vocab_nll(p_head, x: torch.Tensor, labels: torch.Tensor,
              cfg: ModelConfig, shd=None) -> torch.Tensor:
    """``token_nll(logits_apply(p_head, x, cfg), labels)``, the negative
    log likelihood of each label, (..., ) float32.  With ``shd`` the head
    holds this rank's columns of the vocabulary (a tied head, the
    embedding's rows): x enters the model line, the rank's logits stay
    its own, and the maximum, the sum of exponentials and the gold logit
    are reduced over the line (``VocabNLL``); the whole logits are never
    gathered."""
    vl = line(shd, "vocab")
    if vl.size == 1:
        return token_nll(logits_apply(p_head, x, cfg), labels)
    group = "embed" if "table" in p_head else "head"
    p_head = gathered(shd, p_head, group)
    x = enter(x, vl)
    logits = (x @ p_head["table"].T if "table" in p_head
              else x @ p_head["w"]).float()
    n = logits.shape[-1]
    lo = vl.index * n
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(lo, lo + n, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e9)
    return VocabNLL.apply(logits, labels, vl)


def head_init(gen, cfg: ModelConfig, device) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {"w": dense_init(gen, cfg.d_model, cfg.vocab_padded,
                            torch_dtype(cfg.param_dtype), device)}


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (..., V) float32, labels (...) integer in [0, V) -> the
    negative log likelihood of each label, logsumexp minus the gold
    logit."""
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """logits (..., V) float32, labels (...) integer.  Mean negative log
    likelihood, over ``mask`` where given."""
    nll = token_nll(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
