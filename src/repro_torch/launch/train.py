"""Training entry point (the reference's ``launch/train.py``): AdamW steps of
the port's LM on the synthetic LM data, with gradient-accumulation
microbatching, a straggler watchdog and an optional loss-curve CSV.  It
trains the ssm family only; the hybrid, dense, MoE (GQA and MLA), encdec
and VLM families are served, not trained yet, and ``train`` refuses them
(ROADMAP: the rest of the LM scaffold, training of the hybrid, dense,
MoE, MLA, encdec and VLM families).

    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \\
        --reduced --steps 3 --batch 2 --seq 32 --device cpu

Without ``--device`` it runs on the card.  ``train`` is the loop as a
function, for scripts that drive it and read its losses and timings.  The
reference's ``--mesh`` waits for the port of its ``distributed/`` sharding
(ROADMAP: the rest of the LM scaffold), and ``--checkpoint-dir`` and
``--save-every`` for ``checkpoint/manager.py`` (ROADMAP: checkpointing and
the HLO readers).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..data import DataPipeline
from ..device import resolve_device
from ..distributed import make_train_step
from ..models import LM, build_model
from ..optim import get_optimizer
from .serve import set_matmul_policy


def train(cfg, model: LM, *, batch: int, seq: int, steps: int,
          lr: float = 3e-3, microbatches: int = 1, seed: int = 0,
          device=None, log_every: int = 10,
          straggler_factor: float = 3.0) -> dict:
    """Train ``model``, the port's ``LM`` of ``cfg``, for ``steps`` steps
    of ``batch`` sequences of ``seq`` tokens from ``DataPipeline(seed=
    seed).batch_at(step)``, with the config's optimizer at learning rate
    ``lr`` and ``microbatches`` gradient-accumulation chunks a step.  Runs on
    ``device`` (the card unless ``"cpu"``), where the model must lie; the
    parameters are updated in place.

    Returns the per-step ``losses`` and ``grad_norms`` (floats),
    ``step_s`` (a step's device work, from its batch on the host to its
    loss back on the host), ``data_s`` (the host's batch generation, not
    in ``step_s``), ``tokens_per_s`` (batch x seq / step_s) and
    ``stragglers`` (steps slower than ``straggler_factor`` x the running
    median)."""
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.family} family is not ported "
            f"yet (ROADMAP: the rest of the LM scaffold, {cfg.family} "
            "training: the hybrid, dense, MoE, MLA (deepseek-v2-236b), "
            "encdec (whisper-small) and VLM (phi-3-vision-4.2b) families "
            "are served, not trained); the port trains the ssm family "
            "only")
    if min(batch, seq, steps, microbatches) < 1:
        raise ValueError("batch, seq, steps and microbatches must be >= 1")
    dev = resolve_device(device)
    if model.device.type != dev.type or \
            dev.index not in (None, model.device.index):
        raise ValueError(f"the model is on {model.device}, training on {dev}")
    dev = model.device
    opt = get_optimizer(cfg.optimizer, lr=lr)
    params = list(model.parameters())
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, microbatches=microbatches)
    data = DataPipeline(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed)
    out = {"losses": [], "grad_norms": [], "step_s": [], "data_s": [],
           "tokens_per_s": [], "stragglers": []}
    for s in range(steps):
        t0 = time.perf_counter()
        host = data.batch_at(s)
        t1 = time.perf_counter()
        tensors = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                   for k, v in host.items()}
        metrics = step_fn(opt_state, tensors)
        loss = float(metrics["loss"])             # waits for the card
        gnorm = float(metrics["grad_norm"])
        dt = time.perf_counter() - t1
        out["losses"].append(loss)
        out["grad_norms"].append(gnorm)
        out["step_s"].append(dt)
        out["data_s"].append(t1 - t0)
        out["tokens_per_s"].append(batch * seq / dt)
        med = float(np.median(out["step_s"][-50:]))
        if s > 5 and dt > straggler_factor * med:
            out["stragglers"].append(s)
            print(f"[watchdog] straggler step {s}: {dt:.2f}s "
                  f"(median {med:.2f}s)")
        if s % log_every == 0 or s == steps - 1:
            print(f"[train] step={s} loss={loss:.4f} grad_norm={gnorm:.4f} "
                  f"{dt:.2f}s ({batch * seq / dt:.0f} tok/s)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        epilog="Not ported yet: the reference's --mesh (ROADMAP: the rest "
               "of the LM scaffold, distributed/) and --checkpoint-dir and "
               "--save-every (ROADMAP: checkpoint/manager.py).")
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--curve-out", default=None,
                    help="CSV path for the loss curve")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (custom model size)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--d-ff", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..configs import get_config

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    overrides = {k: getattr(args, k) for k in
                 ("d_model", "n_layers", "d_ff", "vocab")
                 if getattr(args, k) is not None}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    print(f"[train] matmul policy {set_matmul_policy()}")
    model = build_model(cfg, device=args.device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"device={model.device}")
    res = train(cfg, model, batch=args.batch, seq=args.seq,
                steps=args.steps, lr=args.lr,
                microbatches=args.microbatches, device=model.device,
                log_every=args.log_every,
                straggler_factor=args.straggler_factor)
    if args.curve_out:
        os.makedirs(os.path.dirname(args.curve_out) or ".", exist_ok=True)
        with open(args.curve_out, "w") as f:
            f.write("step,loss\n")
            for s, loss in enumerate(res["losses"]):
                f.write(f"{s},{loss:.5f}\n")
        print(f"[train] wrote {args.curve_out}")
    print(f"[train] final loss {res['losses'][-1]:.4f} "
          f"(first {res['losses'][0]:.4f})")
    return res


if __name__ == "__main__":
    main()
