"""Adafactor with the reference's semantics (``optim/adafactor.py``): no
first moment; second moments of g^2 + eps kept factored, as row and
column means, for every leaf of two or more axes; the update g / sqrt(v)
divided by max(1, RMS(update) / clip); float32 statistics, parameters
kept in their storage dtype, and AdamW's linear warmup of the learning
rate.  State is O(rows + cols) a matrix, which is what lets a full-width
llama3-405b layer train on one card.

The reference updates its *stacked* parameter tree: each leaf of a layer
group holds every layer on axis 0 (``interop.STACKS``: the LM's
``layers``, the encoder-decoder's ``enc_layers`` and ``dec_layers``).
Two things follow, and this port keeps both:

- a per-layer vector (a norm's scale, (D,)) is an (L, D) leaf there, so
  it is factored: one row statistic a layer (L,), one column statistic
  (D,) taken across the layers;
- the RMS that the clip divides by is taken over the whole stacked leaf:
  over every layer at once, and for MoE experts over all L x E experts.

So ``init`` takes the model's named parameters (``named_parameters()``)
and forms one group per stacked reference leaf: ``blocks.<i>.<rest>``
for every i is one group, the reference's ``layers.<rest>``.  A tensor given without a
name is a group of its own, as an unstacked reference leaf is.  The
update never stacks a group's members (one llama3-405b layer's MLP is
2.6 B parameters): it keeps each group's row and column statistics and
its sum of squares, and walks a large matrix in blocks of rows, so no
float32 temporary is larger than ``BLOCK`` elements.  The parameters and
the statistics are written in place.

On a mesh (``init(..., shd=)``) each rank holds its block of every leaf
and the statistics of that block (a row statistic cut as the leaf's
rows, a column statistic as its columns).  A mean over a dim that the
sharder cuts is the local sum summed over that dim's line, over the
whole dim's size, and the clip's RMS sums its squares over every line
that cuts the leaf: the step is the whole leaf's, as the reference's
GSPMD step computes it.  The statistics are not cut further over the
data line (ZeRO-1 is AdamW's here; Adafactor's are O(rows + cols)).
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .adamw import Optimizer, named_tensors

# the largest float32 temporary of the update, in elements
BLOCK = 1 << 26
_LAYER = re.compile(r"^(blocks|enc_layers|dec_layers)\.\d+\.(.+)$")


def group_key(name):
    """The reference leaf that the port parameter ``name`` is one layer
    of (``blocks.3.mlp.w_up`` -> ``blocks.mlp.w_up``), or ``None`` when
    the parameter is a leaf of its own."""
    if name is None:
        return None
    m = _LAYER.match(name)
    return None if m is None else f"{m.group(1)}.{m.group(2)}"


def _lines(name, shape, shd):
    """(the parameter ``name``'s placement under ``shd``, the line that
    cuts each dim of its local ``shape``, None for a whole dim; the
    whole shape)."""
    if shd is None or name is None:
        return (None,) * len(shape), [None] * len(shape), tuple(shape)
    from ..distributed.sharding import param_spec
    placement = shd.placement(param_spec(name, shd.cfg))
    axes = [None if r is None else shd.mesh.axis(r) for r in placement]
    whole = tuple(s * (a.size if a else 1) for s, a in zip(shape, axes))
    return placement, axes, whole


def stat_placements(grp) -> dict:
    """{statistic: its placement} of an ``init`` group, from its
    members': a row statistic is placed as the rows, a column statistic
    as the columns (a stacked vector's row statistic, one a layer, is
    whole)."""
    P = tuple(grp["placement"])
    if grp["kind"] == "stacked_vector":
        return {"vr": (None,), "vc": P}
    if grp["kind"] == "matrix":
        return {"vr": P[:-1], "vc": P[:-2] + P[-1:]}
    return {"v": P}


def _blocks(shape):
    """(n, r0, r1): the matrices of a (..., R, C) tensor viewed as
    (N, R, C), cut into row blocks of at most BLOCK elements; one block
    (None, None, None) when the whole tensor fits."""
    R, C = shape[-2], shape[-1]
    N = int(np.prod(shape[:-2], dtype=np.int64))
    if N * R * C <= BLOCK:
        return [(None, None, None)]
    rows = max(1, BLOCK // C)
    return [(n, r0, min(R, r0 + rows)) for n in range(N)
            for r0 in range(0, R, rows)]


def _mean(t, dim: int, axis, n: int):
    """``t.mean(dim)`` of a whole dim of size ``n`` that ``axis`` cuts
    (this rank's sum summed over the line); ``t.mean(dim)`` without
    one."""
    if axis is None:
        return t.mean(dim)
    return axis.all_reduce(t.sum(dim)) / n


def adafactor(lr=1e-3, decay=0.8, eps=1e-30, clip=1.0,
              warmup: int = 100) -> Optimizer:
    f32 = np.float32

    def schedule(step: int) -> float:
        """lr * min(1, (step + 1) / warmup), in float32 as the
        reference computes it."""
        warm = min(f32(1.0), (f32(step) + f32(1.0)) / f32(max(1, warmup)))
        return float(f32(lr) * warm)

    def init(params, shd=None) -> dict:
        """State for ``params``: a list of tensors, or of (name, tensor)
        pairs as ``model.named_parameters()`` gives them.  One group per
        reference leaf, with its kind and its float32 statistics:
        "stacked_vector" (per-layer vectors stacked, factored: ``vr``
        (L,), ``vc`` (D,)), "matrix" (each member factored over its last
        two axes: ``vr`` (..., R), ``vc`` (..., C) a member) or "vector"
        (an unfactored ``v`` a member).  With ``shd`` (a ``Sharder``;
        names needed) each group keeps the lines that cut its members'
        dims (``axes``, None for a whole dim) and their whole shape."""
        named = named_tensors(params)
        order, groups = [], {}
        for i, (name, t) in enumerate(named):
            key = group_key(name)
            if key is None:
                key = (i,)
            if key not in groups:
                order.append(key)
                groups[key] = {"key": key, "index": [],
                               "stacked": isinstance(key, str)}
            groups[key]["index"].append(i)
        out = []
        for key in order:
            grp = groups[key]
            members = [named[i][1] for i in grp["index"]]
            shape, dev = tuple(members[0].shape), members[0].device
            grp["placement"], grp["axes"], grp["whole"] = _lines(
                named[grp["index"][0]][0], shape, shd)
            zeros = lambda s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                          device=dev)
            if grp["stacked"] and len(shape) == 1:
                grp.update(kind="stacked_vector", vr=zeros(len(members)),
                           vc=zeros(shape))
            elif len(shape) >= 2:
                grp.update(kind="matrix",
                           vr=[zeros(shape[:-1]) for _ in members],
                           vc=[zeros(shape[:-2] + shape[-1:])
                               for _ in members])
            else:
                grp.update(kind="vector", v=[zeros(shape) for _ in members])
            out.append(grp)
        return {"groups": out, "step": 0}

    def _u(g, vr, rm, vc):
        """g / max(sqrt(vr vc / max(rm, eps)), eps) for g (..., R, C),
        its rows' statistic vr (..., R), the row mean of the whole row
        statistic rm (..., 1) and the column statistic vc (..., C)."""
        denom = torch.sqrt(vr[..., None] * vc[..., None, :]
                           / torch.clamp(rm[..., None], min=eps))
        return g / torch.clamp(denom, min=eps)

    def _matrix_stats(g, vr, vc, beta, grp):
        """Advance one member's row and column statistics in place."""
        ax_r, ax_c = grp["axes"][-2:]
        R_, C_ = grp["whole"][-2:]
        for n, r0, r1 in _blocks(g.shape):
            if n is None:
                g2 = g.float().square().add_(eps)
                vr.mul_(beta).add_((1 - beta) * _mean(g2, -1, ax_c, C_))
                vc.mul_(beta).add_((1 - beta) * _mean(g2, -2, ax_r, R_))
                continue
            R = g.shape[-2]
            gm = g.reshape(-1, R, g.shape[-1])[n]
            vrm = vr.reshape(-1, R)[n]
            vcm = vc.reshape(-1, g.shape[-1])[n]
            if r0 == 0:
                colsum = torch.zeros_like(vcm)
            g2 = gm[r0:r1].float().square().add_(eps)
            vrm[r0:r1].mul_(beta).add_((1 - beta) * _mean(g2, -1, ax_c, C_))
            colsum += g2.sum(0)
            if r1 == R:
                if ax_r is not None:
                    colsum = ax_r.all_reduce(colsum)
                vcm.mul_(beta).add_((1 - beta) * (colsum / R_))

    def _matrix_blocks(g, vr, vc, grp):
        """(slicer, u) over the blocks of one member: ``slicer`` cuts a
        block's rows out of a tensor of the member's shape, ``u`` is the
        unclipped update of those rows."""
        rm = _mean(vr, -1, grp["axes"][-2], grp["whole"][-2])[..., None]
        for n, r0, r1 in _blocks(g.shape):
            if n is None:
                yield (lambda t: t), _u(g.float(), vr, rm, vc)
                continue
            R, C = g.shape[-2], g.shape[-1]

            def rows(t, n=n, r0=r0, r1=r1):
                return t.reshape(-1, R, C)[n, r0:r1]
            yield rows, _u(rows(g).float(), vr.reshape(-1, R)[n, r0:r1],
                           rm.reshape(-1, 1)[n], vc.reshape(-1, C)[n])

    def _group_updates(grp, grads, beta):
        """Advance a group's statistics; returns a function that yields
        (member index, rows slicer, u) over the group's blocks."""
        idx = grp["index"]
        if grp["kind"] == "stacked_vector":
            g = torch.stack([grads[i].float() for i in idx])   # (L, D)
            g2 = g.square().add_(eps)
            grp["vr"].mul_(beta).add_((1 - beta) * _mean(
                g2, -1, grp["axes"][0], grp["whole"][0]))
            grp["vc"].mul_(beta).add_((1 - beta) * g2.mean(-2))
            u = _u(g, grp["vr"], grp["vr"].mean(-1, keepdim=True),
                   grp["vc"])

            def walk():
                for j, i in enumerate(idx):
                    yield i, (lambda t: t), u[j]
            return walk
        if grp["kind"] == "vector":
            for i, v in zip(idx, grp["v"]):
                g2 = grads[i].float().square().add_(eps)
                v.mul_(beta).add_((1 - beta) * g2)

            def walk():
                for i, v in zip(idx, grp["v"]):
                    yield i, (lambda t: t), \
                        grads[i].float() / torch.clamp(torch.sqrt(v),
                                                       min=eps)
            return walk
        for i, vr, vc in zip(idx, grp["vr"], grp["vc"]):
            _matrix_stats(grads[i], vr, vc, beta, grp)

        def walk():
            for i, vr, vc in zip(idx, grp["vr"], grp["vc"]):
                for rows, u in _matrix_blocks(grads[i], vr, vc, grp):
                    yield i, rows, u
        return walk

    @torch.no_grad()
    def update(grads, state, params) -> None:
        """One step on ``params`` (a list of tensors, written in place,
        in ``init``'s order) from ``grads`` (a matching list, any float
        dtype); ``state`` as ``init`` made it, advanced in place."""
        step = state["step"]
        lr_t = schedule(step)
        t = f32(step + 1)
        beta = float(f32(1.0) - t ** f32(-decay))
        for grp in state["groups"]:
            walk = _group_updates(grp, grads, beta)
            # the RMS of the whole group's update, for the clip
            ssq = torch.zeros((), dtype=torch.float32,
                              device=params[grp["index"][0]].device)
            count = 0
            for _, _, u in walk():
                ssq += u.square().sum()
                count += u.numel()
            for axis in {id(a): a for a in grp["axes"] if a}.values():
                ssq = axis.all_reduce(ssq)
                count *= axis.size
            norm = torch.sqrt(ssq / count)
            div = torch.clamp(norm / clip, min=1.0)
            for i, rows, u in walk():
                p = rows(params[i])
                p.copy_(p.float() - lr_t * (u / div))
        state["step"] = step + 1

    return Optimizer(init=init, update=update)
