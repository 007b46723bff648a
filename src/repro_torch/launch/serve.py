"""Batched serving driver: prefill + greedy decode over request waves
(static batch), reporting tokens/s (the reference's ``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu

Without ``--device`` it runs on the card; ``--arch`` defaults to
hymba-1.5b, as the reference's does.  It serves all ten architectures:
ssm (falcon-mamba-7b), hybrid (hymba-1.5b), dense (qwen3-32b,
granite-20b, nemotron-4-340b, llama3-405b), MoE (llama4-scout-17b-a16e
with GQA, deepseek-v2-236b with MLA), encdec (whisper-small) and VLM
(phi-3-vision-4.2b).  The MoE layer's LP capacity router is off in the
shipped configs, as in the reference; a script turns it on with
``dataclasses.replace(cfg, lp_capacity=True)`` before ``build_model``,
and ``serve`` then solves one LP on the card in every MoE layer call.
``serve`` is the loop as a function, for scripts that drive it and read
its tokens and timings.

The encdec and VLM families take stub inputs beside the prompts, those
of the reference's ``launch/cells.py``: whisper's precomputed frame
embeddings (B, F, D), F the prompt length unless ``n_frames`` (the CLI's
``--frames``) says otherwise, and phi-3-vision's patch embeddings
(B, n_patches, D), which prefill puts before the text; both are drawn
from the serving seed's generator after each wave's prompts, in the
config's dtype.  A VLM's decode positions start after its patches.

After prefill, only the cache leaves with a sequence axis that decode
writes are padded to the P + G rows it needs (``pad_kv``): KV leaves,
MLA's two latent leaves, and the encoder-decoder's self-attention KV,
never its cross K/V.  The reference pads every cache leaf whose axis 2
equals P.  The SSM leaves (h, conv) have no sequence axis: at P =
conv_dim - 1 it pads the conv window, at P = d_inner the state; with
frames as long as the prompt it pads the cross K/V, which decode's
cross-attention then reads as encoder rows (ROADMAP queue 3).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models import build_model
from ..models.attention import KVCache
from ..models.encdec import EncDecCache
from ..models.layers import torch_dtype
from ..models.mla import MLACache
from ..models.transformer import HymbaCache


def set_matmul_policy() -> dict:
    """Full-precision products on the card: no TF32 for float32, and bf16
    products reduced in float32 (PyTorch's default lets cuBLAS reduce them
    in bf16).  Returns the two flags as set."""
    m = torch.backends.cuda.matmul
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    return {"allow_tf32": m.allow_tf32,
            "allow_bf16_reduced_precision_reduction":
                m.allow_bf16_reduced_precision_reduction}


def _pad_rows(t: torch.Tensor, total: int) -> torch.Tensor:
    """t zero-padded along axis 2 (the stacked caches' sequence axis) to
    ``total`` rows."""
    return F.pad(t, (0, 0) * (t.dim() - 3) + (0, total - t.shape[2]))


def pad_kv(caches, total: int):
    """The caches with the sequence axis of the leaves decode writes
    (axis 2 of the stacked KV (L, B, S, KV, dh) and MLA latent
    (L, B, S, d) leaves) zero-padded to ``total`` rows; SSM leaves and
    the encoder-decoder's cross K/V unchanged."""
    if isinstance(caches, HymbaCache):
        return caches._replace(kv=pad_kv(caches.kv, total))
    if isinstance(caches, EncDecCache):
        return caches._replace(self_kv=pad_kv(caches.self_kv, total))
    if isinstance(caches, (KVCache, MLACache)):
        return type(caches)(*(_pad_rows(t, total) for t in caches))
    return caches


def stub_inputs(cfg, rng, batch: int, n_frames: int) -> dict:
    """The encdec and VLM families' prefill inputs beside the prompts
    (the reference's ``launch/cells.py`` ``_extra_inputs``), standard
    normal draws from ``rng`` in the config's dtype on the host:
    ``{"frames": (batch, n_frames, D)}``, ``{"patches": (batch,
    n_patches, D)}``, or ``{}`` for every other family."""
    shape = {"encdec": ("frames", n_frames),
             "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if shape is None:
        return {}
    name, rows = shape
    a = rng.standard_normal((batch, rows, cfg.d_model), dtype=np.float32)
    return {name: torch.from_numpy(a).to(torch_dtype(cfg.dtype))}


def serve(cfg, model, *, batch: int, prompt_len: int, gen: int,
          requests: int, seed: int = 0, device=None,
          n_frames: int | None = None) -> dict:
    """Serve ``requests`` waves of ``batch`` prompts of ``prompt_len``
    tokens (drawn from ``np.random.default_rng(seed)``, then the wave's
    stub inputs, ``stub_inputs``: ``n_frames`` frames, default
    ``prompt_len``), generating ``gen`` tokens each by greedy decoding
    with ``model``, the port's ``LM`` or ``EncDecLM`` of ``cfg``.  Runs
    on ``device`` (the card unless ``"cpu"``), where the model must lie,
    under ``torch.inference_mode()``.

    Returns ``tokens`` ((requests, batch, gen) int64), the per-wave
    ``prefill_s`` (a wave's start to its first token on the host: its time
    to first token) and ``decode_s``, ``ttft_s`` (the first wave's),
    ``n_tokens``, ``wall_s`` and ``tokens_per_s``."""
    n_frames = prompt_len if n_frames is None else n_frames
    if min(batch, prompt_len, gen, requests, n_frames) < 1:
        raise ValueError("batch, prompt_len, gen, requests and n_frames "
                         "must be >= 1")
    dev = resolve_device(device)
    if model.device.type != dev.type or \
            dev.index not in (None, model.device.index):
        raise ValueError(f"the model is on {model.device}, serving on {dev}")
    dev = model.device
    rng = np.random.default_rng(seed)
    B, P, G = batch, prompt_len, gen
    # the rows before decode's first: a VLM's patches come first
    P0 = P + (cfg.n_patches if cfg.family == "vlm" else 0)
    tokens = np.zeros((requests, B, G), np.int64)
    prefill_s, decode_s = [], []
    t_start = time.perf_counter()
    with torch.inference_mode():
        for wave in range(requests):
            prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)),
                                      dtype=torch.long, device=dev)
            extra = {k: v.to(dev)
                     for k, v in stub_inputs(cfg, rng, B, n_frames).items()}
            t0 = time.perf_counter()
            logits, caches = model.prefill(prompts, **extra)
            caches = pad_kv(caches, P0 + G)
            tok = logits[:, :cfg.vocab].argmax(-1)
            tokens[wave, :, 0] = tok.cpu().numpy()   # waits for the card
            t1 = time.perf_counter()
            for g in range(G - 1):
                pos = torch.full((B,), P0 + g, dtype=torch.long,
                                 device=dev)
                logits, caches = model.decode_step(caches, tok, pos)
                tok = logits[:, :cfg.vocab].argmax(-1)
                tokens[wave, :, g + 1] = tok.cpu().numpy()
            t2 = time.perf_counter()
            prefill_s.append(t1 - t0)
            decode_s.append(t2 - t1)
            print(f"[serve] wave {wave}: generated {B}x{G} tokens; "
                  f"sample={tokens[wave, 0, :8].tolist()}")
    wall = time.perf_counter() - t_start
    n_tokens = requests * B * G
    print(f"[serve] {n_tokens} tokens in {wall:.2f}s "
          f"({n_tokens / wall:.1f} tok/s, ttft~{prefill_s[0]:.2f}s)")
    return {"tokens": tokens, "n_tokens": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall, "prefill_s": prefill_s,
            "decode_s": decode_s, "ttft_s": prefill_s[0]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--requests", type=int, default=3,
                    help="number of batched request waves")
    ap.add_argument("--frames", type=int, default=None,
                    help="encdec: frames a request (default: the prompt "
                         "length)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..configs import get_config

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"[serve] matmul policy {set_matmul_policy()}")
    model = build_model(cfg, device=args.device)
    return serve(cfg, model, batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, requests=args.requests, device=model.device,
                 n_frames=args.frames)


if __name__ == "__main__":
    main()
