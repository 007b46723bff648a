"""The train, prefill and decode steps (the one-device part of the
reference's ``distributed/steps.py``).

The batch is split along its leading axis into ``microbatches``; each
takes one ``torch.autograd.grad`` of the model's loss, added into float32
accumulators, which are then divided by the microbatch count.  The global
norm clips the gradients (at CLIP_NORM, the reference's default) before
the optimizer's update.
Sharding over ``torch.distributed`` waits for the port of the reference's
``distributed/`` (ROADMAP: the rest of the LM scaffold).
"""
from __future__ import annotations

import torch

CLIP_NORM = 1.0


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over ``tensors`` of their float32 sums of
    squares."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def make_train_step(model, optimizer, microbatches: int = 1):
    """``train_step(opt_state, batch) -> metrics`` for the port's ``LM``
    ``model`` and an ``optim`` optimizer.  ``batch`` is {"tokens",
    "labels"}, (B, S) integer tensors on the model's device, B a multiple
    of ``microbatches``.  The step updates the model's parameters and
    ``opt_state`` in place and returns {"loss", "grad_norm"} as float32
    scalars on the device."""

    def train_step(opt_state, batch):
        params = list(model.parameters())
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{microbatches} microbatches")
        size = B // microbatches
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params]
        losses = []
        for i in range(microbatches):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss = model.loss_fn(mb)
            grads = torch.autograd.grad(loss, params)
            losses.append(loss.detach())
            for a, g in zip(acc, grads):
                a.add_(g)
            del loss, grads   # before the next microbatch's backward
        for a in acc:
            a.div_(microbatches)
        loss = losses[0] if microbatches == 1 else torch.stack(losses).mean()
        gnorm = global_norm(acc)
        scale = torch.clamp(CLIP_NORM / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        for a in acc:
            a.mul_(scale)
        optimizer.update(acc, opt_state, params)
        return {"loss": loss, "grad_norm": gnorm}

    return train_step


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
