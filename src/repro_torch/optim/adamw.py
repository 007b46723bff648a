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

ZeRO-1 (``init(..., shd=)``): a leaf whose ``residual`` dim the
sharder's ``opt_state_spec`` cuts over the data line while the
parameter keeps it whole has moments of this rank's block of that dim
only (``Sharder.zero_dim``).  Every data rank holds the whole summed
gradient, so each updates its block of the parameter, and the blocks
are then gathered over the data line: the parameter every rank ends
with is the unsharded update's, bit for bit.
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


def _block(shape, zero) -> tuple:
    """The moment's shape: ``shape`` with the ZeRO-1 dim cut."""
    if zero is None:
        return tuple(shape)
    dim, axis = zero
    return tuple(s // axis.size if i == dim else s
                 for i, s in enumerate(shape))


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
          warmup: int = 100) -> Optimizer:
    f32 = np.float32

    def schedule(step: int) -> float:
        """lr * min(1, (step + 1) / warmup), in float32 as the
        reference computes it."""
        warm = min(f32(1.0), (f32(step) + f32(1.0)) / f32(max(1, warmup)))
        return float(f32(lr) * warm)

    def init(params, shd=None) -> dict:
        """Zero float32 moments ``m`` and ``v`` beside each parameter of
        ``params`` (tensors, or (name, tensor) pairs; without ``shd`` the
        names change nothing).  With ``shd`` (a ``Sharder``; names
        needed) each moment is this rank's ZeRO-1 block (module
        docstring); ``state["zero"]`` holds each leaf's (dim, data line)
        or None."""
        zero = []
        for name, p in named_tensors(params):
            z = None
            if shd is not None:
                from ..distributed.sharding import param_spec
                z = shd.zero_dim(param_spec(name, shd.cfg))
            zero.append(z)
        zeros = [torch.zeros(_block(p.shape, z), dtype=torch.float32,
                             device=p.device)
                 for (_, p), z in zip(named_tensors(params), zero)]
        return {"m": zeros, "v": [torch.zeros_like(z) for z in zeros],
                "step": 0, "zero": zero}

    def _apply(g, m, v, p, lr_t, bc1, bc2):
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
        for g, m, v, p, z in zip(grads, state["m"], state["v"], params,
                                 state["zero"]):
            if z is None:
                _apply(g, m, v, p, lr_t, bc1, bc2)
                continue
            dim, axis = z
            n = p.shape[dim] // axis.size
            block = p.narrow(dim, axis.index * n, n).contiguous()
            _apply(g.narrow(dim, axis.index * n, n).contiguous(), m, v,
                   block, lr_t, bc1, bc2)
            p.copy_(axis.all_gather(block, dim))
        state["step"] = step + 1

    return Optimizer(init=init, update=update)
