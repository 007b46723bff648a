"""Decoder-only LM assembly (the reference's ``models/transformer.py``),
for the ssm family (falcon-mamba), the hybrid family (hymba: GQA with a
sliding window and Mamba on the same input, mean-fused), the dense family
(qwen3, granite, nemotron, llama3: GQA, then a SwiGLU, GELU or squared
ReLU MLP), the MoE family (llama4-scout with GQA, deepseek-v2 with the
MLA of ``models/mla.py``: attention, then the routed and shared experts
of ``models/moe.py``, with the LP capacity router where the config asks
for it) and the VLM family (phi-3-vision: a dense GQA backbone whose
prefill takes precomputed patch embeddings before the text).  The
encdec family (whisper) is ``models/encdec.py``'s ``EncDecLM``.

``LM`` is an ``nn.Module`` with a ``ModuleList`` of blocks; the reference's
``lax.scan`` over stacked layers becomes a Python loop, and the caches it
returns are stacked on a leading layer axis as the reference's are
(``KVCache`` and ``HymbaCache`` leaves included).  Parameters keep the
reference's names and (in, out) layouts and are trainable; serving runs
under ``torch.inference_mode()``.  ``loss_fn`` is the reference's
sequence-chunked cross entropy, and ``remat="block"`` checkpoints each
block in train mode (``torch.utils.checkpoint``, the counterpart of
``jax.checkpoint``), so the backward recomputes a block's forward, scan
kernel included.

With a sharder (``distributed/sharding.py``) every module is built with
this rank's shapes: each parameter group is drawn whole from the
generator (so the stream, and every value, is the whole model's) and
cut to the block the rank holds (``shard_group``); the blocks run the
tensor-, expert- and vocabulary-parallel functions of the layers they
call.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import KVCache, gqa_apply, gqa_cache_shape, gqa_init
from .config import ModelConfig
from .layers import (TensorSpec, apply_norm, embed_init, embed_lookup,
                     head_init, logits_apply, mlp_apply, mlp_init, norm_init,
                     torch_dtype, vocab_nll)
from .mamba import MambaCache, mamba_apply, mamba_cache_shape, mamba_init
from .mla import mla_apply, mla_cache_shape, mla_init
from .moe import moe_apply, moe_init

# the families LM runs (encdec is EncDecLM's)
PORTED_FAMILIES = ("ssm", "hybrid", "dense", "moe", "vlm")


class HymbaCache(NamedTuple):
    kv: KVCache
    ssm: MambaCache


def map_cache(fn, *caches):
    """``fn`` applied leaf by leaf across caches of one structure (nested
    NamedTuples of tensors or ``TensorSpec``s); a cache of the same
    structure."""
    first = caches[0]
    if isinstance(first, (torch.Tensor, TensorSpec)):
        return fn(*caches)
    return type(first)(*(map_cache(fn, *leaves) for leaves in zip(*caches)))


def _params(tensors: dict) -> nn.ParameterDict:
    """The tensors as parameters under their names; a nested dict (a
    norm inside an attention group) becomes a nested ``ParameterDict``."""
    return nn.ParameterDict({
        k: _params(v) if isinstance(v, dict) else nn.Parameter(v)
        for k, v in tensors.items()})


def shard_group(tensors: dict, group: str, shd, cfg: ModelConfig) -> dict:
    """The whole tensors of the parameter group ``group`` ("attn",
    "mlp", "embed", ...) cut to this rank's blocks under ``shd``
    (``Sharder.local_slices`` of each leaf's ``param_spec``); the
    tensors themselves without a sharder or where nothing is cut."""
    if shd is None:
        return tensors
    from ..distributed.sharding import param_spec
    out = {}
    for k, v in tensors.items():
        if isinstance(v, dict):
            out[k] = shard_group(v, k, shd, cfg)
            continue
        sl = shd.local_slices(param_spec(f"{group}.{k}", cfg), v.shape)
        out[k] = v if all(s == slice(None) for s in sl) else \
            v[sl].clone()
    return out


def group_params(tensors: dict, group: str, shd, cfg: ModelConfig
                 ) -> nn.ParameterDict:
    """``_params`` of this rank's blocks of a group (``shard_group``)."""
    return _params(shard_group(tensors, group, shd, cfg))


def chunked_ce_sum(head, x, labels, cfg: ModelConfig, chunk: int = 1024,
                   shd=None):
    """Sequence-chunked cross entropy of ``x`` (B, S, D) through ``head``
    against ``labels`` (B, S), labels < 0 masked, so that the (S, vocab)
    logits never materialize at once: the float32 sum of the unmasked
    tokens' negative log likelihoods and their count.  The mean is the
    sum over the count (at least one); a data-parallel step adds both
    over the ranks before it divides."""
    S = x.shape[1]
    chunk = min(chunk, S)
    tot = x.new_zeros((), dtype=torch.float32)
    cnt = x.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, chunk):
        ls = labels[:, c0:c0 + chunk]
        nll = vocab_nll(head, x[:, c0:c0 + chunk], ls.clamp(min=0), cfg,
                        shd)
        mask = ls >= 0
        tot = tot + (nll * mask).sum()
        cnt = cnt + mask.sum()
    return tot, cnt


def whole_logits(head, x, cfg: ModelConfig, shd=None) -> torch.Tensor:
    """``logits_apply`` of the whole vocabulary: with ``shd``, this
    rank's block of the head gathered over the model line first (the
    serving steps' last-position logits; training never gathers
    them)."""
    from ..distributed.sharding import gather_placed, param_spec
    if shd is not None:
        group = "embed" if "table" in head else "head"
        head = {k: gather_placed(v, shd.placement(param_spec(
            f"{group}.{k}", cfg)), shd.mesh) for k, v in head.items()}
    return logits_apply(head, x, cfg)


def check_ported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` unless ``LM`` runs ``cfg``: the ssm,
    hybrid, dense, MoE (GQA or MLA) and VLM families.  The encdec family
    is ``EncDecLM``'s, which ``build_model`` returns for it."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: LM does not run the {cfg.family} family "
            f"(attention {cfg.attn_kind}, MLP {cfg.mlp_kind}); it runs the "
            f"{', '.join(PORTED_FAMILIES)} families, and build_model "
            "returns models.encdec.EncDecLM for the encdec family")


class Block(nn.Module):
    """One pre-norm residual block: x + mixer(norm1(x)), then, where the
    config has an MLP (``d_ff`` set, or MoE), x + mlp(norm2(x)).  The
    mixer is MLA where the config's attention is MLA; otherwise the ssm
    family's is Mamba, the hybrid's 0.5 * (gqa(h) + mamba(h)) on the same
    h, and every other family's GQA.  The MLP is the config's kind, MoE
    included."""

    def __init__(self, cfg: ModelConfig, gen, device, shd=None):
        super().__init__()
        self.cfg = cfg
        self.shd = shd
        dtype = torch_dtype(cfg.param_dtype)
        self.norm1 = _params(norm_init(cfg.d_model, cfg.norm_kind, dtype,
                                       device))
        if cfg.attn_kind == "mla":
            self.attn = group_params(mla_init(gen, cfg, device), "attn", shd,
                                     cfg)
        elif cfg.family != "ssm":
            self.attn = group_params(gqa_init(gen, cfg, device), "attn", shd,
                                     cfg)
        if cfg.family in ("ssm", "hybrid"):
            self.ssm = group_params(mamba_init(gen, cfg, device), "ssm", shd,
                                    cfg)
        self.has_mlp = bool(cfg.d_ff) or cfg.mlp_kind == "moe"
        if self.has_mlp:
            self.norm2 = _params(norm_init(cfg.d_model, cfg.norm_kind, dtype,
                                           device))
            init = moe_init if cfg.mlp_kind == "moe" else mlp_init
            self.mlp = group_params(init(gen, cfg, device), "mlp", shd, cfg)

    def forward(self, x, *, mode: str, positions=None, cache=None, pos=None):
        cfg = self.cfg
        h = apply_norm(self.norm1, x, cfg.norm_kind)
        shd = self.shd
        if cfg.attn_kind == "mla":
            a, new_cache = mla_apply(self.attn, h, cfg, positions=positions,
                                     mode=mode, cache=cache, pos=pos, shd=shd)
        elif cfg.family == "hybrid":
            a1, kv_new = gqa_apply(
                self.attn, h, cfg, positions=positions, mode=mode,
                cache=None if cache is None else cache.kv, pos=pos, shd=shd)
            a2, ssm_new = mamba_apply(
                self.ssm, h, cfg, mode=mode,
                cache=None if cache is None else cache.ssm, shd=shd)
            a = 0.5 * (a1 + a2)
            new_cache = None if mode == "train" else HymbaCache(kv_new,
                                                                ssm_new)
        elif cfg.family == "ssm":
            a, new_cache = mamba_apply(self.ssm, h, cfg, mode=mode,
                                       cache=cache, shd=shd)
        else:
            a, new_cache = gqa_apply(self.attn, h, cfg, positions=positions,
                                     mode=mode, cache=cache, pos=pos, shd=shd)
        x = x + a
        if self.has_mlp:
            h2 = apply_norm(self.norm2, x, cfg.norm_kind)
            if cfg.mlp_kind == "moe":
                x = x + moe_apply(self.mlp, h2, cfg, shd=shd)
            else:
                x = x + mlp_apply(self.mlp, h2, cfg, shd=shd)
        return x, new_cache


class LM(nn.Module):
    """Decoder LM of the ssm, hybrid, dense, MoE or VLM family.
    ``generator`` draws the parameters (embedding, blocks, head, in that
    order); ``None`` leaves them uninitialized for
    ``interop.lm_from_reference`` to fill.  ``shd`` (a
    ``distributed.sharding.Sharder``) makes the model this rank's: every
    parameter its block of the whole model's (drawn whole from
    ``generator`` and cut, ``shard_group``), each layer the
    tensor-, expert-, vocabulary- and FSDP-parallel function of it."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None,
                 shd=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.shd = shd
        gen = generator
        self.embed = group_params(embed_init(gen, cfg, device), "embed",
                                  shd, cfg)
        self.blocks = nn.ModuleList(Block(cfg, gen, device, shd)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _params(norm_init(cfg.d_model, cfg.norm_kind,
                                            torch_dtype(cfg.param_dtype),
                                            device))
        self.head = group_params(head_init(gen, cfg, device), "head", shd,
                                 cfg)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # -- embedding frontend ---------------------------------------------------
    def _embed_inputs(self, tokens, patches=None):
        """The tokens' embeddings in the config's dtype, after the
        precomputed patch embeddings (B, n_patches, D) where given (the
        VLM stub)."""
        x = embed_lookup(self.embed, tokens, self.shd).to(
            torch_dtype(self.cfg.dtype))
        if patches is not None:
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        return x

    def _run_layers(self, x, *, mode, positions=None, caches=None,
                    pos=None):
        if mode == "train":
            for block in self.blocks:
                if self.cfg.remat == "block":
                    x, _ = checkpoint(block, x, mode=mode,
                                      positions=positions,
                                      use_reentrant=False)
                else:
                    x, _ = block(x, mode=mode, positions=positions)
            return x, None
        new = []
        for i, block in enumerate(self.blocks):
            cache_l = None if caches is None else \
                map_cache(lambda t: t[i], caches)
            x, c = block(x, mode=mode, positions=positions, cache=cache_l,
                         pos=pos)
            new.append(c)
        return x, map_cache(lambda *ts: torch.stack(ts), *new)

    def _head(self):
        return self.head if len(self.head) else self.embed

    def _logits(self, x):
        x = apply_norm(self.final_norm, x, self.cfg.norm_kind)
        return whole_logits(self._head(), x[:, -1:], self.cfg,
                            self.shd)[:, 0]

    # -- training loss --------------------------------------------------------
    def loss_fn(self, batch):
        """batch: {"tokens": (B, S) integer, "labels": (B, S) integer,
        optional "patches": (B, n_patches, D)}, tensors on the model's
        device.  Labels < 0 are masked; with patches the loss is taken on
        the text positions only.  Returns the mean next-token cross
        entropy (a float32 scalar)."""
        tot, cnt = self.loss_sum(batch)
        return tot / cnt.clamp(min=1.0)

    def loss_sum(self, batch):
        """``loss_fn``'s (sum, count) of the unmasked tokens' losses."""
        patches = batch.get("patches")
        x = self._embed_inputs(batch["tokens"], patches)
        x, _ = self._run_layers(x, mode="train",
                                positions=self._positions(x))
        x = apply_norm(self.final_norm, x, self.cfg.norm_kind)
        labels = batch["labels"]
        if patches is not None:
            x = x[:, -labels.shape[1]:]
        return chunked_ce_sum(self._head(), x, labels, self.cfg,
                              shd=self.shd)

    # -- serving --------------------------------------------------------------
    @staticmethod
    def _positions(x):
        B, S = x.shape[:2]
        return torch.arange(S, device=x.device)[None].expand(B, S)

    def prefill(self, tokens, patches=None):
        """tokens: (B, S) integer; patches: (B, n_patches, D) or None.
        Returns (last-position logits (B, vocab_padded) float32, caches
        stacked on a layer axis; KV and latent leaves hold the
        n_patches + S prompt rows, patches first)."""
        x = self._embed_inputs(tokens, patches)
        x, caches = self._run_layers(x, mode="prefill",
                                     positions=self._positions(x))
        return self._logits(x), caches

    def decode_step(self, caches, token, pos):
        """token: (B,) integer; pos: (B,) the position each sequence
        writes and attends from (its KV row; the ssm family keeps no
        positional state).  Returns (logits (B, vocab_padded), updated
        caches)."""
        x = self._embed_inputs(token[:, None])
        x, new_caches = self._run_layers(x, mode="decode",
                                         positions=pos[:, None],
                                         caches=caches, pos=pos)
        return self._logits(x), new_caches

    # -- cache shapes ---------------------------------------------------------
    def cache_shape(self, batch: int, seq: int):
        """Shapes of the stacked caches, the reference's: MLA's latent
        leaves hold ``seq`` rows; the ssm family's do not grow with
        ``seq``; KV leaves (the hybrid's, the dense, GQA MoE and VLM
        families') are ``gqa_cache_shape``'s (window-sized where the
        config has a window, see there)."""
        cfg = self.cfg
        L = cfg.n_layers

        def stack(tree):
            return map_cache(lambda s: TensorSpec((L,) + s.shape, s.dtype),
                             tree)

        if cfg.attn_kind == "mla":
            return stack(mla_cache_shape(cfg, batch, seq))
        if cfg.family == "ssm":
            return stack(mamba_cache_shape(cfg, batch))
        if cfg.family == "hybrid":
            return stack(HymbaCache(kv=gqa_cache_shape(cfg, batch, seq),
                                    ssm=mamba_cache_shape(cfg, batch)))
        return stack(gqa_cache_shape(cfg, batch, seq))
