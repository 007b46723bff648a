"""The train, prefill and decode steps (the reference's
``distributed/steps.py``), on one device or over a mesh.

The batch is split along its leading axis into ``microbatches``; each
takes one ``torch.autograd.grad`` of the model's loss, added into float32
accumulators, which are then divided by the microbatch count.  The global
norm clips the gradients (at CLIP_NORM, the reference's default) before
the optimizer's update.

With a sharder (``distributed/sharding.py``) the step is the reference's
under GSPMD on its mesh, as the port executes it:

* every rank is handed the global batch and takes its rows: microbatch i
  is rows [i B / M, (i + 1) B / M), split over the data line as the
  reference's ``batch`` rule splits it (each rank of a model line takes
  the same rows);
* the loss is the mean over the global microbatch, every unmasked token
  counted once: each rank's sum is divided by the count summed over the
  data line, and the ranks' quotients are summed, never averaged;
* each rank holds its block of every leaf (``Sharder.placement``) and
  its gradient of that block.  A leaf sharded over the model line has
  no sum there; a leaf replicated on it gets its whole gradient from
  the Megatron pair around the tensor-parallel regions, except those
  that see only this rank's share (``Sharder.model_summed``: the MoE
  router under expert parallelism, the qk-norm scales and GQA's
  unsharded K and V projections under sharded heads), which are summed
  over the model line.  FSDP's leaves were reduce-scattered over the
  data line in the backward (``GatherLeaf``); every other leaf is
  summed over it;
* the clip's global norm sums each leaf's squares once, over the axes
  that shard it;
* the optimizer updates each rank's blocks in place (ZeRO-1: AdamW's
  moments cut further over the data line, ``optim/adamw.py``).

``check_replicas`` holds every leaf equal bit for bit over each line it
is not sharded on (the mesh runs deterministic algorithms on the card,
``sharding.make_mesh``).
"""
from __future__ import annotations

import torch

from .sharding import Sharder, param_spec

CLIP_NORM = 1.0


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over ``tensors`` of their float32 sums of
    squares."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def local_rows(batch: int, microbatches: int, data_size: int = 1,
               data_index: int = 0) -> list:
    """The row slice of the global batch each microbatch hands this rank
    (module docstring); raises unless the batch splits evenly."""
    if batch % (microbatches * data_size):
        raise ValueError(f"batch {batch} does not split into {microbatches} "
                         f"microbatches over {data_size} data ranks")
    size = batch // microbatches
    per = size // data_size
    return [slice(i * size + data_index * per,
                  i * size + (data_index + 1) * per)
            for i in range(microbatches)]


class _Plan:
    """The mesh lines and each parameter's place in the reductions."""

    def __init__(self, model, shd: Sharder | None):
        shd = shd or Sharder(model.cfg, None)
        self.shd = shd
        self.data, self.model_line = shd.data_axis(), shd.model_axis()
        names = [n for n, _ in model.named_parameters()]
        self.axes = [shd.shard_axes(param_spec(n, model.cfg))
                     for n in names]
        self.summed = [shd.model_summed(n) for n in names]

    def rows(self, batch: dict, microbatches: int,
             local: bool = False) -> list:
        if local:   # the batch handed over is this rank's rows already
            return local_rows(batch["tokens"].shape[0], microbatches)
        return local_rows(batch["tokens"].shape[0], microbatches,
                          self.data.size, self.data.index)

    def local(self, model, mb: dict, params):
        """This rank's share of the global microbatch's mean loss and its
        gradients (module docstring), before the reductions."""
        tot, cnt = model.loss_sum(mb)
        loss = tot / self.data.all_reduce(cnt.detach()).clamp(min=1.0)
        return loss, torch.autograd.grad(loss, params)

    def reduce(self, grads: list) -> list:
        out = []
        for g, axes, summed in zip(grads, self.axes, self.summed):
            if summed:
                g = self.model_line.all_reduce(g)
            # the data-parallel axes an FSDP reduce-scatter has not summed
            rest = tuple(a for a in self.shd.dp_axes if a not in axes)
            if rest == self.shd.dp_axes:
                g = self.data.all_reduce(g)
            elif rest:
                g = self.shd.mesh.axis(rest).all_reduce(g)
            out.append(g)
        return out


def loss_and_grads(model, batch: dict, shd: Sharder | None = None):
    """The mean loss of the global ``batch`` and the gradients of this
    rank's parameters (in ``model.parameters()`` order, reduced over the
    mesh as the train step reduces them), without an optimizer step:
    (loss, grads), the loss a float32 scalar, the same on every rank."""
    plan = _Plan(model, shd)
    params = list(model.parameters())
    loss, grads = plan.local(model, {k: v[plan.rows(batch, 1)[0]]
                                     for k, v in batch.items()}, params)
    return plan.data.all_reduce(loss.detach()), plan.reduce(list(grads))


def make_train_step(model, optimizer, microbatches: int = 1,
                    shd: Sharder | None = None, local_batch: bool = False):
    """``train_step(opt_state, batch) -> metrics`` for the port's ``LM``
    ``model`` and an ``optim`` optimizer.  ``batch`` is {"tokens",
    "labels"} (and a family's frames or patches), (B, S) tensors on the
    model's device, B a multiple of ``microbatches`` (times the data
    ranks with ``shd``: the global batch, of which each rank takes its
    rows; with ``local_batch`` this rank's rows already, as the dry
    run's cells hand them over).  The step updates the model's
    parameters and ``opt_state`` in place and returns {"loss",
    "grad_norm"} as float32 scalars on the device, the same on every
    rank."""
    plan = _Plan(model, shd)

    def train_step(opt_state, batch):
        params = list(model.parameters())
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params]
        losses = []
        for sl in plan.rows(batch, microbatches, local_batch):
            loss, grads = plan.local(model, {k: v[sl]
                                             for k, v in batch.items()},
                                     params)
            losses.append(loss.detach())
            for a, g in zip(acc, grads):
                a.add_(g)
            del loss, grads   # before the next microbatch's backward
        acc = plan.reduce(acc)
        for a in acc:
            a.div_(microbatches)
        loss = plan.data.all_reduce(torch.stack(losses)).mean()
        gnorm = _norm(acc, plan.axes, plan.shd)
        scale = torch.clamp(CLIP_NORM / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        for a in acc:
            a.mul_(scale)
        optimizer.update(acc, opt_state, params)
        return {"loss": loss, "grad_norm": gnorm}

    return train_step


def _norm(grads, axes, shd: Sharder) -> torch.Tensor:
    """The global norm of the whole model's gradients: each leaf's
    squares summed once, over the mesh axes that shard it (leaves
    grouped by those axes, each group's sum reduced over them)."""
    zero = grads[0].new_zeros((), dtype=torch.float32)
    groups = {}
    for g, ax in zip(grads, axes):
        groups[ax] = groups.get(ax, zero) + g.float().square().sum()
    total = zero
    for ax in sorted(groups, key=sorted):
        part = groups[ax]
        for a in sorted(ax):
            part = shd.mesh.axis(a).all_reduce(part)
        total = total + part
    return torch.sqrt(total)


_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def check_replicas(model, shd: Sharder | None) -> int:
    """Raise ``RuntimeError`` unless every rank of each mesh line (model,
    and the data-parallel line) holds each parameter that the line does
    not shard bit for bit as this rank does (one digest a leaf, the
    int64 sum of its bits, gathered over the line).  Returns the number
    of (leaf, line) pairs compared: 0 without a line of several
    ranks."""
    if shd is None or shd.mesh is None:
        return 0
    plan = _Plan(model, shd)
    named = [(n, p.detach()) for n, p in model.named_parameters()]
    count = 0
    for line, names in ((shd.model_axis(), (shd.tp_axis,)),
                        (shd.data_axis(), shd.dp_axes)):
        if line.size == 1:
            continue
        mine = [(n, p) for (n, p), ax in zip(named, plan.axes)
                if not ax & set(names)]
        if not mine:
            continue
        digest = torch.stack([p.contiguous().view(_BITS[p.element_size()])
                              .sum(dtype=torch.int64) for _, p in mine])
        every = line.all_gather(digest[None], 0)
        differ = (every != digest).any(0).tolist()
        if any(differ):
            bad = [n for (n, _), d in zip(mine, differ) if d]
            raise RuntimeError(f"{len(bad)} replicated leaves differ across "
                               f"the {'x'.join(line.names)} line: {bad[:4]}")
        count += len(mine)
    return count


def make_prefill_step(model):
    """``prefill_step(tokens, extra=None) -> (logits, caches)``, the
    model's prefill, as the reference's: ``extra``'s "patches" go to
    ``LM.prefill`` (a VLM's patch embeddings, for any family, as the
    reference passes them) and its "frames" to ``EncDecLM.prefill``;
    other keys are ignored.  Frames on an ``LM`` or patches on an
    ``EncDecLM`` raise ``TypeError``, as the reference's prefills, which
    do not take them, do."""

    def prefill_step(tokens, extra=None):
        kw = {k: extra[k] for k in ("patches", "frames")
              if k in (extra or {})}
        return model.prefill(tokens, **kw)

    return prefill_step


def make_decode_step(model):
    """``decode_step(caches, token, pos) -> (logits, caches)``, the
    model's decode step."""

    def decode_step(caches, token, pos):
        return model.decode_step(caches, token, pos)

    return decode_step
