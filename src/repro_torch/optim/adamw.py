"""AdamW with the reference's semantics (``optim/adamw.py``): moments in
float32, parameters kept in their storage dtype (bf16 parameters are
rounded back to bf16 after each update), a linear warmup of the learning
rate, and the weight-decay term inside the step.

``torch.optim.AdamW`` is not this function: it keeps bf16 moments for bf16
parameters and folds the decay in another order.  The reference's update
is pure; this one writes the parameters and moments in place, which saves
a copy of each at the full model's size, and walks each parameter in
flat blocks of at most ``BLOCK`` elements, so that the update's float32
temporaries stay small beside a full-width embedding (1 B parameters in
llama4-scout's).  The update is elementwise: the blocks change no bit.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

# the largest float32 temporary of the update, in elements
BLOCK = 1 << 26


class Optimizer(NamedTuple):
    init: Callable    # params or named params -> state
    update: Callable  # (grads, state, params) -> None, in place


def named_tensors(params) -> list:
    """[(name or None, tensor)] of ``params``: tensors, or (name, tensor)
    pairs as ``model.named_parameters()`` gives them."""
    return [p if isinstance(p, tuple) else (None, p) for p in params]


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
          warmup: int = 100) -> Optimizer:
    f32 = np.float32

    def schedule(step: int) -> float:
        """lr * min(1, (step + 1) / warmup), in float32 as the
        reference computes it."""
        warm = min(f32(1.0), (f32(step) + f32(1.0)) / f32(max(1, warmup)))
        return float(f32(lr) * warm)

    def init(params) -> dict:
        """Zero float32 moments ``m`` and ``v`` beside each parameter of
        ``params`` (tensors, or (name, tensor) pairs; the names change
        nothing)."""
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for _, p in named_tensors(params)]
        return {"m": zeros, "v": [torch.zeros_like(z) for z in zeros],
                "step": 0}

    @torch.no_grad()
    def update(grads, state, params) -> None:
        """One step on ``params`` (a list of tensors, written in place)
        from ``grads`` (a matching list, any float dtype); ``state`` as
        ``init`` made it, advanced in place."""
        step = state["step"]
        lr_t = schedule(step)
        t = f32(step + 1)
        bc1 = float(f32(1.0) - f32(b1) ** t)
        bc2 = float(f32(1.0) - f32(b2) ** t)
        for g, m, v, p in zip(grads, state["m"], state["v"], params):
            # view: a parameter written through a copy would not change
            g = g.reshape(-1)
            m, v, p = (x.view(-1) for x in (m, v, p))
            for i in range(0, p.numel(), BLOCK):
                gi, mi, vi, pi = (x[i:i + BLOCK] for x in (g, m, v, p))
                gi = gi.float()
                mi.mul_(b1).add_((1 - b1) * gi)
                vi.mul_(b2).add_((1 - b2) * gi.square())
                p32 = pi.float()
                step_val = (mi / bc1) / ((vi / bc2).sqrt() + eps) \
                    + weight_decay * p32
                pi.copy_(p32 - lr_t * step_val)
        state["step"] = step + 1

    return Optimizer(init=init, update=update)
