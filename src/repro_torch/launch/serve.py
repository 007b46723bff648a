"""Batched serving driver: prefill + greedy decode over request waves
(static batch), reporting tokens/s (the reference's ``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu

Without ``--device`` it runs on the card; ``--arch`` defaults to
hymba-1.5b, as the reference's does.  It serves every family the port
runs: ssm (falcon-mamba-7b), hybrid (hymba-1.5b), dense (qwen3-32b,
granite-20b, nemotron-4-340b, llama3-405b) and MoE (llama4-scout-17b-a16e).
The MoE layer's LP capacity router is off in the shipped configs, as in
the reference; a script turns it on with
``dataclasses.replace(cfg, lp_capacity=True)`` before ``build_model``,
and ``serve`` then solves one LP on the card in every MoE layer call.  ``serve`` is the loop as a
function, for scripts that drive it and read its tokens and timings.
After prefill, only the KV leaves' sequence axis is padded from the
prompt length P to P + G rows (``pad_kv``; the dense and MoE families'
caches are all KV leaves).  The reference pads every
cache leaf whose axis 2 equals P, and the SSM leaves (h, conv) have no
sequence axis: at P = conv_dim - 1 it pads the conv window, at P =
d_inner the state (ROADMAP queue 3).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models import LM, build_model
from ..models.attention import KVCache
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


def pad_kv(caches, total: int):
    """The caches with their KV leaves' sequence axis (axis 2 of the
    stacked (L, B, S, KV, dh)) zero-padded to ``total`` rows; SSM leaves
    unchanged."""
    if isinstance(caches, HymbaCache):
        return caches._replace(kv=pad_kv(caches.kv, total))
    if isinstance(caches, KVCache):
        return KVCache(*(F.pad(t, (0, 0, 0, 0, 0, total - t.shape[2]))
                         for t in caches))
    return caches


def serve(cfg, model: LM, *, batch: int, prompt_len: int, gen: int,
          requests: int, seed: int = 0, device=None) -> dict:
    """Serve ``requests`` waves of ``batch`` prompts of ``prompt_len``
    tokens (drawn from ``np.random.default_rng(seed)``), generating
    ``gen`` tokens each by greedy decoding with ``model``, the port's
    ``LM`` of ``cfg``.  Runs on ``device`` (the card unless ``"cpu"``),
    where the model must lie, under ``torch.inference_mode()``.

    Returns ``tokens`` ((requests, batch, gen) int64), the per-wave
    ``prefill_s`` (a wave's start to its first token on the host: its time
    to first token) and ``decode_s``, ``ttft_s`` (the first wave's),
    ``n_tokens``, ``wall_s`` and ``tokens_per_s``."""
    if min(batch, prompt_len, gen, requests) < 1:
        raise ValueError("batch, prompt_len, gen and requests must be >= 1")
    dev = resolve_device(device)
    if model.device.type != dev.type or \
            dev.index not in (None, model.device.index):
        raise ValueError(f"the model is on {model.device}, serving on {dev}")
    dev = model.device
    rng = np.random.default_rng(seed)
    B, P, G = batch, prompt_len, gen
    tokens = np.zeros((requests, B, G), np.int64)
    prefill_s, decode_s = [], []
    t_start = time.perf_counter()
    with torch.inference_mode():
        for wave in range(requests):
            prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)),
                                      dtype=torch.long, device=dev)
            t0 = time.perf_counter()
            logits, caches = model.prefill(prompts)
            caches = pad_kv(caches, P + G)
            tok = logits[:, :cfg.vocab].argmax(-1)
            tokens[wave, :, 0] = tok.cpu().numpy()   # waits for the card
            t1 = time.perf_counter()
            for g in range(G - 1):
                pos = torch.full((B,), P + g, dtype=torch.long, device=dev)
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
                 gen=args.gen, requests=args.requests, device=model.device)


if __name__ == "__main__":
    main()
