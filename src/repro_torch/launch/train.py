"""Training entry point (the reference's ``launch/train.py``): optimizer
steps of the port's model on the synthetic LM data, with
gradient-accumulation microbatching, a straggler watchdog and an optional
loss-curve CSV.  It trains every family: ssm (falcon-mamba-7b), hybrid
(hymba-1.5b), dense (qwen3-32b, granite-20b, nemotron-4-340b,
llama3-405b), MoE with GQA (llama4-scout-17b-a16e) and with MLA
(deepseek-v2-236b), encdec (whisper-small) and VLM (phi-3-vision-4.2b),
with the config's optimizer (AdamW, or Adafactor for llama3-405b and
nemotron-4-340b); ``--reduced`` trains the CPU-sized config with AdamW,
as the reference's CLI does.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
        --reduced --steps 3 --batch 2 --seq 32 --device cpu

Without ``--device`` it runs on the card.  ``train`` is the loop as a
function, for scripts that drive it and read its losses and timings.

Each step's tokens and labels are ``DataPipeline.batch_at(step)``.  The
encdec and VLM families take stub inputs beside them, as ``serve`` does
(``launch/serve.py`` ``stub_inputs``): whisper's frame embeddings
(batch, n_frames, D), n_frames the sequence length unless ``--frames``
says otherwise (whisper's window is 1,500), and phi-3-vision's patch
embeddings (batch, n_patches, D), drawn from a generator seeded by
(seed, step) in the config's dtype.  The reference's CLI feeds neither,
so it cannot train whisper (ROADMAP queue 3); its ``loss_fn`` and train
step, given the same inputs, are what the port is held to.

``--mesh DxM`` trains over a (data, model) mesh of D x M ranks
(``distributed/sharding.py``): each rank reads the global batch from
``batch_at(step)`` and takes its rows, and holds and computes only its
block of each leaf that the reference's rules shard (the attention
heads, ``ff``, ``ff_expert``, ``d_inner``, the vocabulary and the MoE
experts over the model axis, FSDP's ``residual`` over the data axis),
with AdamW's moments cut further over the data axis (ZeRO-1).  The
model is built sharded, the state drawn or restored sharded, and the
parameters a rank holds are printed.  The ranks come
from ``torchrun`` (``launch/mesh.py`` ``join_world``): ranks that share
one card, or run on the CPU, exchange over gloo, ranks that own a card
each over NCCL.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama4-scout-17b-a16e --reduced --mesh 2x2 --steps 4 \
        --batch 4 --seq 32 --checkpoint-dir /tmp/ckpt --device cpu

``--checkpoint-dir`` resumes from the newest checkpoint there (its
parameters, the optimizer's state and ``extra["data_step"]``, the next
step to take) and saves every ``--save-every`` steps from a writer
thread and once at the end (``checkpoint/manager.py``).  A checkpoint
holds whole arrays, so a run may resume on another mesh.  At each save
and at the end every rank of a model line checks that it holds the
replicated parameters bit for bit as the others do
(``distributed/steps.py`` ``check_replicas``), and raises if not.  The
straggler watchdog and the log run on rank 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..data import DataPipeline
from ..device import resolve_device
from ..distributed import make_train_step
from ..distributed.steps import check_replicas
from ..distributed.sharding import Sharder, make_mesh
from ..models import LM, build_model
from ..optim import get_optimizer
from .mesh import join_world
from .serve import set_matmul_policy, stub_inputs


def step_batch(cfg, data: DataPipeline, step: int, *, seed: int,
               n_frames: int, device) -> dict:
    """Step ``step``'s batch on ``device``: ``data.batch_at(step)``'s
    tokens and labels as int64, and for the encdec and VLM families
    ``stub_inputs`` drawn from ``np.random.default_rng((seed, step))``
    in the config's dtype."""
    host = data.batch_at(step)
    out = {k: torch.as_tensor(v, dtype=torch.long, device=device)
           for k, v in host.items()}
    rng = np.random.default_rng((seed, step))
    for k, v in stub_inputs(cfg, rng, data.local_batch, n_frames).items():
        out[k] = v.to(device)
    return out


def train(cfg, model: LM, *, batch: int, seq: int, steps: int,
          lr: float = 3e-3, microbatches: int = 1, seed: int = 0,
          device=None, log_every: int = 10,
          straggler_factor: float = 3.0, optimizer: str | None = None,
          n_frames: int | None = None, shd: Sharder | None = None,
          checkpoint_dir: str | None = None, save_every: int = 50) -> dict:
    """Train ``model``, the port's ``LM`` or ``EncDecLM`` of ``cfg``, for
    ``steps`` steps of ``batch`` sequences of ``seq`` tokens from
    ``DataPipeline(seed=seed).batch_at(step)`` (with the encdec and VLM
    families' stub inputs, ``step_batch``: ``n_frames`` frames, default
    ``seq``), with the optimizer ``optimizer`` (default the config's) at
    learning rate ``lr`` and ``microbatches`` gradient-accumulation
    chunks a step.  Runs on ``device`` (the card unless ``"cpu"``), where
    the model must lie; the parameters are updated in place.

    Returns the per-step ``losses`` and ``grad_norms`` (floats),
    ``step_s`` (a step's device work, from its batch on the device to its
    loss back on the host), ``data_s`` (the host's batch generation and
    its copy to the device, not in ``step_s``), ``tokens_per_s`` (batch x
    seq / step_s: the text tokens), ``stragglers`` (steps slower than
    ``straggler_factor`` x the running median) and ``replicas_checked``
    (the replicated leaves held equal over the model line at the end, 0
    without one).

    With ``shd`` (its mesh over the ranks of a ``torch.distributed``
    world, ``model`` built with it) every rank runs this with the same
    arguments and takes its rows of each global batch.  With
    ``checkpoint_dir`` the run resumes from the newest checkpoint there,
    taking its steps from ``extra["data_step"]`` up to ``steps`` (the
    lists then hold those steps only; ``start`` says where they begin),
    and saves every ``save_every`` steps and at the end."""
    n_frames = seq if n_frames is None else n_frames
    if min(batch, seq, steps, microbatches, n_frames) < 1:
        raise ValueError("batch, seq, steps, microbatches and n_frames "
                         "must be >= 1")
    dev = resolve_device(device)
    if model.device.type != dev.type or \
            dev.index not in (None, model.device.index):
        raise ValueError(f"the model is on {model.device}, training on {dev}")
    dev = model.device
    name = optimizer or cfg.optimizer
    opt = get_optimizer(name, lr=lr)
    # named: Adafactor groups the layers of one stacked reference leaf
    opt_state = opt.init(list(model.named_parameters()), shd=shd)
    step_fn = make_train_step(model, opt, microbatches=microbatches, shd=shd)
    data = DataPipeline(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed)
    lead = shd is None or shd.mesh.rank == 0
    start, mgr = 0, None
    if checkpoint_dir:
        mgr = CheckpointManager(checkpoint_dir)
        latest = mgr.latest_step()
        if latest is not None:
            restore_state(mgr, latest, model, opt_state, shd)
            start = int(mgr.extra(latest).get("data_step", latest))
            if lead:
                print(f"[train] resumed from step {latest}", flush=True)
    out = {"losses": [], "grad_norms": [], "step_s": [], "data_s": [],
           "tokens_per_s": [], "stragglers": [], "start": start}
    for s in range(start, steps):
        t0 = time.perf_counter()
        tensors = step_batch(cfg, data, s, seed=seed, n_frames=n_frames,
                             device=dev)
        t1 = time.perf_counter()
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
        if lead and s - start > 5 and dt > straggler_factor * med:
            out["stragglers"].append(s)
            print(f"[watchdog] straggler step {s}: {dt:.2f}s "
                  f"(median {med:.2f}s)")
        if lead and (s % log_every == 0 or s == steps - 1):
            print(f"[train] step={s} loss={loss:.4f} grad_norm={gnorm:.4f} "
                  f"{dt:.2f}s ({batch * seq / dt:.0f} tok/s)", flush=True)
        done = s + 1
        if mgr and done < steps and done % save_every == 0:
            check_replicas(model, shd)
            mgr.save(done, state_tree(model, opt_state), blocking=False,
                     extra={"data_step": done}, sharder=shd,
                     specs=state_specs(opt_state))
    out["replicas_checked"] = check_replicas(model, shd)
    if mgr:
        mgr.wait()
        mgr.save(steps, state_tree(model, opt_state),
                 extra={"data_step": steps}, sharder=shd,
                 specs=state_specs(opt_state))
    return out


def state_tree(model, opt_state) -> dict:
    """The checkpoint's tree: {"params": {name: parameter}, "opt": the
    optimizer's tensors and step}, AdamW's moments keyed by their
    parameters' names, Adafactor's statistics group by group."""
    names = [n for n, _ in model.named_parameters()]
    if "m" in opt_state:
        opt = {k: dict(zip(names, opt_state[k])) for k in ("m", "v")}
    else:
        opt = {"groups": [{k: g[k] for k in ("vr", "vc", "v") if k in g}
                          for g in opt_state["groups"]]}
    opt["step"] = opt_state["step"]
    return {"params": dict(model.named_parameters()), "opt": opt}


def state_specs(opt_state) -> dict:
    """{path: placement} of the checkpoint's optimizer leaves that their
    paths do not place (``checkpoint/manager.py``): Adafactor's
    statistics, each placed as its group's members' dims."""
    from ..checkpoint.manager import flatten
    from ..optim.adafactor import stat_placements
    out = {}
    for i, g in enumerate(opt_state.get("groups", [])):
        if "placement" not in g:
            continue
        for stat, placement in stat_placements(g).items():
            for path, _ in flatten(g[stat], f"opt.groups.{i}.{stat}."):
                out[path] = placement
    return out


@torch.no_grad()
def restore_state(mgr: CheckpointManager, step: int, model, opt_state,
                  shd: Sharder | None = None) -> None:
    """Load checkpoint ``step`` into ``model``'s parameters and
    ``opt_state`` in place, each rank its slice under ``shd``."""
    like = state_tree(model, opt_state)
    got = mgr.restore(step, like, sharder=shd, device=model.device,
                      specs=state_specs(opt_state))

    def copy(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                copy(dst[k], src[k])
        elif isinstance(dst, list):
            for d, s_ in zip(dst, src):
                copy(d, s_)
        elif isinstance(dst, torch.Tensor):
            dst.copy_(src)

    copy(like, got)
    opt_state["step"] = got["opt"]["step"]


def main(argv=None):
    ap = argparse.ArgumentParser(
        epilog="Trains every family with the config's optimizer (AdamW "
               "under --reduced); the encdec and VLM families get stub "
               "frames or patches each step.  --mesh DxM runs under "
               "torchrun with D x M ranks: data parallel, every leaf the "
               "reference's rules shard held and computed in blocks "
               "(tensor, expert and vocabulary parallel over the model "
               "axis, FSDP and ZeRO-1 over the data axis).")
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-sized config of the same family, "
                         "trained with AdamW")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default=None, help="e.g. 2x2 (data x model)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--curve-out", default=None,
                    help="CSV path for the loss curve")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (custom model size)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--d-ff", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None,
                    help="encdec: stub frames a sequence (default --seq)")
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
    shd, device = None, args.device
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split("x"))
        device = join_world(shape, args.device)
        shd = Sharder(cfg, make_mesh(shape, ("data", "model")[:len(shape)],
                                     device=device))
    lead = shd is None or shd.mesh.rank == 0
    policy = set_matmul_policy()
    model = build_model(cfg, device=device, shd=shd)
    n_params = sum(p.numel() for p in model.parameters())
    optimizer = "adamw" if args.reduced else cfg.optimizer
    if lead:
        print(f"[train] matmul policy {policy}")
        print(f"[train] arch={cfg.name} params={n_params / 1e6:.1f}M "
              f"(this rank's) optimizer={optimizer} device={model.device} "
              f"mesh={args.mesh}")
    res = train(cfg, model, batch=args.batch, seq=args.seq,
                steps=args.steps, lr=args.lr,
                microbatches=args.microbatches, device=model.device,
                log_every=args.log_every,
                straggler_factor=args.straggler_factor,
                optimizer=optimizer, n_frames=args.frames, shd=shd,
                checkpoint_dir=args.checkpoint_dir,
                save_every=args.save_every)
    if not res["losses"]:
        return res
    if args.curve_out and lead:
        os.makedirs(os.path.dirname(args.curve_out) or ".", exist_ok=True)
        with open(args.curve_out, "w") as f:
            f.write("step,loss\n")
            for s, loss in enumerate(res["losses"], res["start"]):
                f.write(f"{s},{loss:.5f}\n")
        print(f"[train] wrote {args.curve_out}")
    if lead:
        print(f"[train] final loss {res['losses'][-1]:.4f} "
              f"(first {res['losses'][0]:.4f})")
    return res


if __name__ == "__main__":
    main()
