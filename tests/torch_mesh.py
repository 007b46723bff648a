"""Gloo worlds for the port's mesh tests (tests/test_torch_ep.py,
test_torch_checkpoint.py, test_torch_train_mesh.py) and the work their
ranks do.

``spawn`` starts the ranks of one gloo world as ``python -c`` processes on
a file store (no network), as tests/test_torch_distributed.py does; each
rank runs ``RANK``, which initialises the world and calls a function of
this module by name with a job file and an output path.  This module
imports only the port, so a rank never loads JAX.  ``spawn_reference``
runs a script of the reference on an XLA host mesh in a subprocess.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TESTS = os.path.dirname(os.path.abspath(__file__))

RANK = textwrap.dedent("""
    import sys
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, fn, job, out = sys.argv[1:7]
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=int(rank), world_size=int(world))
    import torch_mesh
    try:
        getattr(torch_mesh, fn)(job, out)
    finally:
        dist.barrier()
        dist.destroy_process_group()
""")


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), TESTS]), OMP_NUM_THREADS="1", **extra)


def spawn(world: int, fn: str, job, tmp, tag: str):
    """Start ``world`` ranks of a gloo world, each calling ``fn(job
    path, output path)``; ``job`` is pickled for them.  Returns a waiter
    that joins the ranks and returns what rank 0 wrote."""
    job_path, out = tmp / f"{tag}.job", tmp / f"{tag}.out"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(world),
         str(tmp / f"{tag}.store"), fn, str(job_path), str(out)],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]

    def wait(timeout=600):
        logs = [p.communicate(timeout=timeout) for p in procs]
        for p, (so, se) in zip(procs, logs):
            assert p.returncode == 0, f"STDOUT:\n{so}\nSTDERR:\n{se[-4000:]}"
        with open(out, "rb") as f:
            return pickle.load(f)
    return wait


def spawn_reference(code: str, devices: int, tmp, tag: str, job=None):
    """Run ``code`` (a reference script reading its job from argv[1] and
    writing its result to argv[2]) on ``devices`` XLA host devices;
    returns a waiter for the unpickled result."""
    job_path, out = tmp / f"{tag}.job", tmp / f"{tag}.out"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    env = _env(JAX_PLATFORMS="cpu", XLA_FLAGS=(
        f"--xla_force_host_platform_device_count={devices}"))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             str(job_path), str(out)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def wait(timeout=600):
        _, err = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, err[-4000:]
        with open(out, "rb") as f:
            return pickle.load(f)
    return wait


def to_torch(b):
    return {k: torch.from_numpy(np.asarray(v)).long()
            if np.asarray(v).dtype.kind == "i"
            else torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _load(job):
    with open(job, "rb") as f:
        return pickle.load(f)


def _dump(out, obj):
    if dist.get_rank() == 0:
        with open(out, "wb") as f:
            pickle.dump(obj, f)


def _same_on_every_rank(t) -> bool:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return all(bool(torch.equal(p, t)) for p in parts)


# ---- work done in the ranks --------------------------------------------------

def loss_and_grads(job, out):
    """Every case of the job whose mesh has the world's size: the port's
    sharded loss and gradients of the reduced model carried from the
    reference's parameters, the gradients gathered to whole arrays in
    the reference's tree (rank 0 writes {case: (loss, grads, replicated
    grads equal across ranks)})."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (Sharder, gather_params,
                                                  make_mesh, param_spec)
    from repro_torch.distributed.steps import loss_and_grads as step_grads
    from repro_torch.interop import lm_from_reference, lm_to_reference
    import dataclasses
    job = _load(job)
    world = dist.get_world_size()
    done = {}
    for case in job["cases"]:
        arch, shape, kw = case[0], case[1], dict(case[2])
        if int(np.prod(shape)) != world:
            continue
        cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        shd = Sharder(cfg, mesh)
        lm = lm_from_reference(cfg, job["params"][arch], "cpu", shd=shd)
        batch = job.get("arch_batch", {}).get(arch, job["batch"])
        loss, grads = step_grads(lm, to_torch(batch), shd)
        names = [n for n, _ in lm.named_parameters()]
        rep = {n: g for n, g in zip(names, grads)
               if not shd.is_sharded(param_spec(n, cfg))}
        same = all(_same_on_every_rank(g) for g in rep.values())
        whole = gather_params(dict(zip(names, grads)), shd)
        done[case] = (float(loss), lm_to_reference(
            lm, [whole[n] for n in names]), same)
    _dump(out, done)


def train_steps(job, out):
    """Every case (arch, mesh, changes, microbatches) of the job whose
    mesh has the world's size: ``job["steps"]`` steps of the port's
    ``make_train_step(shd=)`` with the config's optimizer (AdamW, or
    Adafactor for the reduced llama3-405b and nemotron-4-340b;
    ``job["lr"]``, ``job["warmup"]``, AdamW's moments under ZeRO-1) on
    ``job["batches"]`` (``job["arch_batches"][arch]`` where given), from
    the reference's parameters.  Rank 0 writes {case: (losses, grad
    norms, the whole parameters in the reference's tree, the (leaf,
    line) pairs ``check_replicas`` compared, and whether it then caught
    one ulp changed on one rank)}."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (Sharder, gather_params,
                                                  make_mesh)
    from repro_torch.distributed.steps import (check_replicas,
                                               make_train_step)
    from repro_torch.interop import lm_from_reference, lm_to_reference
    from repro_torch.optim import get_optimizer
    import dataclasses
    job = _load(job)
    world = dist.get_world_size()
    done = {}
    for case in job["cases"]:
        arch, shape, kw, microbatches = case
        if int(np.prod(shape)) != world:
            continue
        cfg = dataclasses.replace(get_config(arch).reduced(), **dict(kw))
        shd = Sharder(cfg, make_mesh(shape, ("data", "model"), device="cpu"))
        lm = lm_from_reference(cfg, job["params"][arch], "cpu", shd=shd)
        opt = get_optimizer(cfg.optimizer, lr=job["lr"],
                            warmup=job["warmup"])
        state = opt.init(list(lm.named_parameters()), shd=shd)
        step = make_train_step(lm, opt, microbatches=microbatches, shd=shd)
        losses, norms = [], []
        for b in job.get("arch_batches", {}).get(arch, job["batches"]):
            m = step(state, to_torch(b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        names = [n for n, _ in lm.named_parameters()]
        whole = gather_params({n: p.detach()
                               for n, p in lm.named_parameters()}, shd)
        checked = check_replicas(lm, shd)
        # one ulp of one replicated entry on the model line's last rank
        norm = "dec_norm.scale" if cfg.family == "encdec" else \
            "final_norm.scale"
        if shd.model_axis().index == shd.model_axis().size - 1:
            with torch.no_grad():
                dict(lm.named_parameters())[norm].view(torch.int32)[0] += 1
        try:
            check_replicas(lm, shd)
            caught = False
        except RuntimeError as e:
            caught = norm in str(e)
        done[case] = (losses, norms, lm_to_reference(
            lm, [whole[n] for n in names]), checked, caught)
    _dump(out, done)


def train_cli(job, out):
    """``launch.train.main(job["argv"])`` in this world; rank 0 writes
    its losses and this rank's parameters' whole arrays (gathered)."""
    from repro_torch.distributed.sharding import gather_params
    from repro_torch.launch import train as train_mod
    job = _load(job)
    seen = {}
    real = train_mod.train

    def keep(cfg, model, **kw):
        seen["model"], seen["shd"] = model, kw.get("shd")
        return real(cfg, model, **kw)

    train_mod.train = keep
    try:
        res = train_mod.main(job["argv"])
    finally:
        train_mod.train = real
    model, shd = seen["model"], seen["shd"]
    params = {n: p.detach() for n, p in model.named_parameters()}
    if shd is not None:
        params = gather_params(params, shd)
    _dump(out, {"losses": res["losses"], "start": res["start"],
                "params": {n: p.cpu().numpy() for n, p in params.items()}})


def checkpoint_elastic(job, out):
    """Save the reduced llama4-scout's parameters and AdamW state from a
    (2, 2) mesh (each rank its blocks of the leaves, the moments cut
    further by ZeRO-1, gathered on save), then restore the checkpoint on
    a (1, 4) mesh of the same world: rank 0 writes, per mesh, whether
    every rank's restored leaves equal its slices of the whole arrays
    (its ZeRO-1 slices for the moments).  Then Adafactor's statistics
    (``adafactor_stats``), saved from (2, 2) with their placements and
    restored on (1, 4): per mesh, whether every rank's equal its
    blocks."""
    import dataclasses
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (Sharder, make_mesh,
                                                  param_spec, shard_params)
    from repro_torch.launch.train import state_specs, state_tree
    from repro_torch.models import build_model
    from repro_torch.optim import get_optimizer
    job = _load(job)
    cfg = dataclasses.replace(get_config(job["arch"]).reduced(),
                              **job["changes"])
    whole = build_model(cfg, device="cpu", seed=job["seed"])
    opt = get_optimizer("adamw")
    done = {}
    for shape, step in (((2, 2), 1), ((1, 4), None)):
        shd = Sharder(cfg, make_mesh(shape, ("data", "model"), device="cpu"))
        model = build_model(cfg, device="cpu", seed=job["seed"], shd=shd)
        state = opt.init(list(model.named_parameters()), shd=shd)
        moments = {n: shd.local_slices(param_spec(n, cfg), p.shape,
                                       zero=True)
                   for n, p in whole.named_parameters()}
        state["m"] = [p.detach()[moments[n]] + 0.5
                      for n, p in whole.named_parameters()]
        state["step"] = 7
        mgr = CheckpointManager(job["dir"])
        if step is not None:
            mgr.save(step, state_tree(model, state), sharder=shd,
                     extra={"data_step": step})
            dist.barrier()
        got = mgr.restore(1, state_tree(model, state), sharder=shd)
        want = shard_params({n: p.detach()
                             for n, p in whole.named_parameters()}, shd)
        ok = all(torch.equal(got["params"][n], want[n]) for n in want) and \
            all(torch.equal(got["opt"]["m"][n],
                            0.5 + p.detach()[moments[n]])
                for n, p in whole.named_parameters()) and \
            got["opt"]["step"] == 7
        sliced = any(got["params"][n].shape != p.shape
                     for n, p in whole.named_parameters())
        done[shape] = (_same_on_every_rank(torch.tensor([ok, sliced])),
                       ok, sliced)
    # Adafactor's statistics, placed as their members' dims, the same way
    af = get_optimizer("adafactor")
    stats = adafactor_stats(whole)
    for shape, step in (((2, 2), 1), ((1, 4), None)):
        shd = Sharder(cfg, make_mesh(shape, ("data", "model"), device="cpu"))
        model = build_model(cfg, device="cpu", seed=job["seed"], shd=shd)
        state = af.init(list(model.named_parameters()), shd=shd)
        want = _local_stats(state, stats, shd)
        mgr = CheckpointManager(job["af_dir"])
        if step is not None:
            for g, w in zip(state["groups"], want):
                for k, v in w.items():
                    g[k] = v
            mgr.save(step, state_tree(model, state), sharder=shd,
                     specs=state_specs(state))
            dist.barrier()
        got = mgr.restore(1, state_tree(model, state), sharder=shd,
                          specs=state_specs(state))
        ok = all(torch.equal(a, b) for g, w in zip(got["opt"]["groups"], want)
                 for k in w for a, b in zip(_leaves(g[k]), _leaves(w[k])))
        done[("adafactor",) + shape] = _same_on_every_rank(
            torch.tensor([ok]))
    _dump(out, done)


def adafactor_stats(model):
    """Adafactor's state of ``model``'s whole parameters with every
    statistic filled with distinct values (0.25 a step from the group's
    index)."""
    from repro_torch.optim import get_optimizer
    state = get_optimizer("adafactor").init(list(model.named_parameters()))
    for i, g in enumerate(state["groups"]):
        for k in ("vr", "vc", "v"):
            for t in _leaves(g.get(k, [])):
                t.copy_(i + 0.25 * torch.arange(t.numel()).reshape(t.shape))
    return state


def _leaves(x):
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _local_stats(state, whole, shd):
    """Each group's statistics of ``whole`` (the whole model's state)
    cut to this rank's blocks by their placements."""
    from repro_torch.optim.adafactor import stat_placements
    out = []
    for g, w in zip(state["groups"], whole["groups"]):
        cut = {}
        for k, placement in stat_placements(g).items():
            parts = [t[shd.place_slices(placement, t.shape)].clone()
                     for t in _leaves(w[k])]
            cut[k] = parts[0] if isinstance(w[k], torch.Tensor) else parts
        out.append(cut)
    return out


def serve_steps(job, out):
    """Every case (arch, mesh, changes) of the job whose mesh has the
    world's size: the reduced config (seed 0) built sharded over the
    mesh and whole in this process; this rank's rows of the prompts
    prefilled and decoded ``job["gen"]`` greedy steps on each.  Rank 0
    writes {case: [(rank, the largest |sharded - whole| of the logits at
    every step, of every cache leaf (this rank's block of the whole
    cache) after prefill and after the last step, the greedy tokens
    equal, the mesh's collectives by kind)] of every rank}."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Sharder, make_mesh
    from repro_torch.launch.cells import cache_logical_spec
    from repro_torch.launch.serve import pad_kv
    from repro_torch.models import build_model
    job = _load(job)
    world = dist.get_world_size()
    done = {}
    for case in job["cases"]:
        arch, shape, kw = case
        if int(np.prod(shape)) != world:
            continue
        cfg = dataclasses.replace(get_config(arch).reduced(), **dict(kw))
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        shd = Sharder(cfg, mesh)
        mine = build_model(cfg, device="cpu", seed=0, shd=shd)
        whole = build_model(cfg, device="cpu", seed=0)
        tokens = torch.from_numpy(np.asarray(job["tokens"])).long()
        dl = shd.data_axis()
        per = tokens.shape[0] // dl.size
        rows = slice(dl.index * per, (dl.index + 1) * per)
        P, G = tokens.shape[1], job["gen"]

        def block(t, logical):
            """This rank's block of a whole stacked cache leaf."""
            sl = list(shd.place_slices(shd.placement(logical, t.shape),
                                       t.shape))
            sl[logical.index("batch")] = rows
            return t[tuple(sl)]

        def cache_err(got, want):
            errs = []

            def one(g, w, lg):
                errs.append(float((g.float() - block(w, lg).float())
                                  .abs().max()))
                return g
            _zip(one, got, want, cache_logical_spec(cfg))
            return max(errs)

        with torch.inference_mode():
            got_l, got_c = mine.prefill(tokens[rows])
            want_l, want_c = whole.prefill(tokens)
            errs = [float((got_l - want_l[rows]).abs().max())]
            c_errs = [cache_err(got_c, want_c)]
            got_c, want_c = pad_kv(got_c, P + G), pad_kv(want_c, P + G)
            same = True
            for g in range(G):
                tok = want_l.argmax(-1)
                same &= bool(torch.equal(got_l.argmax(-1), tok[rows]))
                pos = torch.full((tokens.shape[0],), P + g, dtype=torch.long)
                got_l, got_c = mine.decode_step(got_c, tok[rows], pos[rows])
                want_l, want_c = whole.decode_step(want_c, tok, pos)
                errs.append(float((got_l - want_l[rows]).abs().max()))
            c_errs.append(cache_err(got_c, want_c))
        mine_out = (dist.get_rank(), errs, c_errs, same,
                    mesh.exchanges()["kinds"])
        every = [None] * world
        dist.all_gather_object(every, mine_out)
        done[case] = every
    _dump(out, done)


def _zip(fn, a, b, c):
    if isinstance(a, torch.Tensor):
        return fn(a, b, c)
    for x, y, z in zip(a, b, c):
        _zip(fn, x, y, z)
