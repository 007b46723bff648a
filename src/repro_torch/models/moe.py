"""Mixture-of-Experts (the reference's ``models/moe.py``) on one device:
top-k token choice into fixed per-expert capacity slots, SwiGLU experts
as three batched products, and the shared experts as a dense SwiGLU MLP.

Routing is in float32: the router product ``x @ router`` is taken in x's
dtype and then widened, as the reference's has no
``preferred_element_type``.  The top k are the first k of a stable
descending sort, which breaks ties to the lower expert as
``jax.lax.top_k`` does (``torch.topk`` does not).  A token's slot is its
rank among the tokens routed to its expert, in token order (an exclusive
cumsum of the one-hot).  Overflow is dropped through a sentinel row: a
dropped token's destination is the row past the (E x capacity) buffer,
which the dispatch adds zero into and the combine reads as zero, so the
shapes stay static and nothing branches on the data.

LP capacity (``cfg.lp_capacity``, the paper's technique inside the LM):
instead of the uniform cutoff ``slot < capacity``, the router's soft
demand ``probs.sum(0) * k`` sets per-expert caps through
``core.lp_router.expert_capacity_lp``, one small LP solved by the
whole-solve simplex kernel on the card (its plain version on a CPU
tensor), and a token is kept while ``slot < cap`` of its expert.  The
integer slot is compared with the float cap, unrounded, as the
reference's caller does.  The buffer's shape does not change; only the
mask does.

No step of the layer reads a value back to the host (no boolean
indexing, no ``nonzero``, no ``.item()``), so decode runs it once a
layer a step without a host synchronization, the router's solve
included.

Expert parallelism (``moe_apply(..., shd=)``, the reference's
``shard_map`` path): when the sharder's ``experts`` rule resolves to the
model axis and tp > 1, each rank holds E / tp expert slabs and routes
its local tokens: its rows of the batch (the data-parallel step gives it
only those) and, under ``seq_sp`` where the sequence divides tp, its
slice of the sequence.  The capacity comes from the local token count,
and with ``lp_capacity`` each rank solves its own (1, E) LP, as each
shard of the reference does.  The (tp, El x C, D) send buffer goes out by
one all-to-all over the model line, the SwiGLU experts run on the El
local slabs, a second all-to-all brings the results back, and the
combine is local; under ``seq_sp`` the output is gathered back along the
sequence.  Without ``seq_sp`` every model rank routes the same tokens,
each expert receives tp copies, and the cotangent of the (replicated)
output is split tp ways, as the reference's ``shard_map`` transpose
does; the input's cotangent is then summed over the line.  Each exchange
is an autograd function whose backward is the inverse exchange
(``distributed/sharding.py``).  Over gloo an exchange copies its buffer
to the host and back: that copy is the only host synchronization the
sharded layer adds.  The shared experts stay outside the exchange,
tensor parallel on ``ff_expert``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.lp_router import expert_capacity_lp
from ..distributed.sharding import (AllToAll, EnterReplicated, GatherSeq,
                                    LeaveReplicated, ScatterSeq, enter,
                                    gathered, line, reduce_over)
from .config import ModelConfig
from .layers import dense_init, normal_init, torch_dtype


def moe_init(gen, cfg: ModelConfig, device) -> dict:
    """router (D, E); w_gate, w_up (E, D, Fe) and w_down (E, Fe, D); with
    shared experts ws_gate, ws_up (D, Fs) and ws_down (Fs, D), Fs =
    n_shared_experts x Fe.  The reference's scales: N(0, 1/D) for the
    router, the expert inputs and the shared MLP's, N(0, 1/Fe) for
    w_down and N(0, 1/Fs) for ws_down.  A rank's expert slabs are cut from
    these by ``transformer.shard_group``."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dtype = torch_dtype(cfg.param_dtype)
    p = {"router": dense_init(gen, D, E, dtype, device),
         "w_gate": normal_init(gen, (E, D, Fe), 1.0 / math.sqrt(D), dtype,
                               device),
         "w_up": normal_init(gen, (E, D, Fe), 1.0 / math.sqrt(D), dtype,
                             device),
         "w_down": normal_init(gen, (E, Fe, D), 1.0 / math.sqrt(Fe), dtype,
                               device)}
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        p["ws_gate"] = dense_init(gen, D, Fs, dtype, device)
        p["ws_up"] = dense_init(gen, D, Fs, dtype, device)
        p["ws_down"] = dense_init(gen, Fs, D, dtype, device)
    return p


def _capacity(n_tok: int, k: int, E: int, cf: float) -> int:
    """Slots an expert: ceil(n_tok k / E x cf), rounded up to a multiple
    of 4, at least 4."""
    c = int(math.ceil(n_tok * k / E * cf))
    return max(4, (c + 3) // 4 * 4)


class Routing(NamedTuple):
    """Where each of the N x K (token, choice) pairs goes, token-major."""
    top_w: torch.Tensor          # (N, K) float32, renormalized
    expert: torch.Tensor         # (N*K,) int64
    slot: torch.Tensor           # (N*K,) int32, rank within the expert
    keep: torch.Tensor           # (N*K,) bool
    demand: Optional[torch.Tensor]   # (1, E) float32 with lp_capacity
    caps: Optional[torch.Tensor]     # (E,) float32 with lp_capacity


def route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
          capacity: int) -> Routing:
    """x: (N, D) tokens.  Top-k routing over the E experts with
    ``capacity`` slots each, cut at the uniform capacity or, with
    ``cfg.lp_capacity``, at the LP's caps."""
    N = x.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = (x @ router).float()                            # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :K], top_e[:, :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)

    expert = top_e.reshape(-1)                               # (N*K,)
    onehot = (expert[:, None] == torch.arange(E, device=x.device)) \
        .to(torch.int32)
    ranks = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = ranks.gather(1, expert[:, None])[:, 0]

    demand = caps = None
    if cfg.lp_capacity:
        demand = probs.sum(0)[None, :] * K                   # (1, E)
        caps = expert_capacity_lp(demand, total_slots=float(N * K),
                                  c_max=float(capacity))[0]
        keep = slot < caps[expert]
    else:
        keep = slot < capacity
    return Routing(top_w, expert, slot, keep, demand, caps)


def _moe_local(x: torch.Tensor, p, cfg: ModelConfig,
               axis=None) -> torch.Tensor:
    """The routed experts on x: (N, D) tokens -> (N, D) in x's dtype (the
    reference's ``_moe_local``).  ``axis`` is the model line the experts
    are sharded over (p holds this rank's El = E / tp slabs), None at
    tp = 1."""
    N, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    tp = 1 if axis is None else axis.size
    El = p["w_gate"].shape[0]
    C = _capacity(N, K, E, cfg.capacity_factor)
    r = route(x, p["router"], cfg, C)

    # dispatch: each kept pair to its (expert, slot) row, the dropped ones
    # to the sentinel row; every live row receives one token, so the add
    # is a copy.  Expert e lives on rank e // El, so the buffer's rows are
    # (rank, local expert, slot)
    sent = E * C
    dest = torch.where(r.keep, r.expert * C + r.slot, sent)
    xk = x[:, None, :].expand(N, K, D).reshape(N * K, D)
    buf = x.new_zeros((sent + 1, D)).index_add_(
        0, dest, xk * r.keep[:, None].to(x.dtype))
    buf = buf[:sent].reshape(tp, El * C, D)
    if axis is not None:
        buf = AllToAll.apply(buf, axis)
    # rows grouped by source rank, for this rank's experts
    h_in = buf.reshape(tp, El, C, D).transpose(0, 1).reshape(El, tp * C, D)

    # the SwiGLU experts, in the parameters' dtype
    g = torch.bmm(h_in, p["w_gate"])
    u = torch.bmm(h_in, p["w_up"])
    y = torch.bmm(F.silu(g) * u, p["w_down"])

    # the return path, then combine: the sentinel row reads zero
    y = y.reshape(El, tp, C, D).transpose(0, 1).reshape(tp, El * C, D)
    if axis is not None:
        y = AllToAll.apply(y, axis)
    y_flat = torch.cat([y.reshape(sent, D), y.new_zeros((1, D))])
    z = y_flat[dest]                                         # (N*K, D)
    w = (r.top_w.reshape(-1) * r.keep).to(x.dtype)
    return (z * w[:, None]).reshape(N, K, D).sum(1)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, shd=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): the routed experts over the B x S
    tokens, plus the shared experts where the config has them.  With a
    sharder whose experts are sharded (``Sharder.expert_axis``), the
    expert-parallel path of the module docstring; x is this rank's rows
    of the batch.  The shared experts are tensor parallel on
    ``ff_expert``, and FSDP's leaves (the slabs' ``residual`` dim over
    the data line, the router, the shared experts) are gathered before
    the products."""
    B, S, D = x.shape
    p = gathered(shd, p, "mlp")
    axis = None if shd is None else shd.expert_axis()
    if axis is None:
        out = _moe_local(x.reshape(B * S, D), p, cfg).reshape(B, S, D)
    else:
        seq_sp = shd.act_spec(x.shape, "batch", "seq_sp", None)[1] \
            is not None
        xl = (ScatterSeq if seq_sp else EnterReplicated).apply(x, axis)
        Bl, Sl, _ = xl.shape
        out = _moe_local(xl.reshape(Bl * Sl, D), p, cfg, axis) \
            .reshape(Bl, Sl, D)
        out = (GatherSeq if seq_sp else LeaveReplicated).apply(out, axis)
    if cfg.n_shared_experts:
        fe = line(shd, "ff_expert")
        xs = enter(x, fe)
        h = F.silu(xs @ p["ws_gate"]) * (xs @ p["ws_up"])
        out = out + reduce_over(h @ p["ws_down"], fe)
    return out
