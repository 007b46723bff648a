"""Three-term roofline of a dry-run cell on the H100 (the reference's
``analysis/roofline.py``).

The numerators are one rank's, from ``analysis/op_cost.py``'s trace of
its share of the step (every rank of the production meshes does the
same work), so the denominators are one card's peaks:

    compute_s    = flops_per_rank       / 989e12  (bf16 dense, H100 SXM)
    memory_s     = bytes_per_rank       / 3.35e12 (HBM3)
    collective_s = coll_bytes_per_rank  / 50e9    (one 400 Gb/s port)

The peaks are NVIDIA's data-sheet numbers for the SXM part at its 700 W
power limit, dense (no sparsity).  The collective term takes one DGX
H100 card's InfiniBand NDR port, 400 Gb/s = 50 GB/s: a 16 x 16 mesh over
hosts of 8 cards crosses hosts on every line.  A line inside one host
would run over NVLink at 450 GB/s each way.

MODEL_FLOPS = 6 N_active tokens (train) or 2 N_active tokens (+ the
attention term for decode), as the reference counts it; MODEL_FLOPS /
(traced flops x chips) exposes recompute and padding.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..models.config import ModelConfig, ShapeCell

PEAK_FLOPS = 989e12     # bf16 / card, dense (H100 SXM data sheet)
HBM_BW = 3.35e12        # bytes/s / card (HBM3)
LINK_BW = 50e9          # bytes/s / card: one 400 Gb/s InfiniBand NDR port
NVLINK_BW = 450e9       # bytes/s each way inside one host, for reference
HBM_BYTES = 80e9        # device memory / card


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_total: float
    useful_ratio: float
    bottleneck: str

    def as_dict(self):
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "model_flops": self.model_flops,
            "hlo_flops_total": self.hlo_flops_total,
            "useful_ratio": self.useful_ratio,
            "bottleneck": self.bottleneck,
        }


def active_params(cfg: ModelConfig, total_params: float) -> float:
    """Active (per-token) parameter count: total minus unrouted experts."""
    if cfg.mlp_kind != "moe":
        return total_params
    inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * 3 \
        * cfg.d_model * cfg.d_ff_expert
    return total_params - inactive


def model_flops(cfg: ModelConfig, cell: ShapeCell, total_params: float) -> float:
    n_act = active_params(cfg, total_params)
    tokens = cell.global_batch * cell.seq_len
    if cell.kind == "train":
        base = 6.0 * n_act * tokens
    elif cell.kind == "prefill":
        base = 2.0 * n_act * tokens
    else:  # decode: one token per sequence + cache-attention reads
        base = 2.0 * n_act * cell.global_batch
        if cfg.n_heads and cfg.attn_kind != "none":
            S_eff = min(cell.seq_len, cfg.sliding_window or cell.seq_len)
            base += (4.0 * cell.global_batch * cfg.n_layers * S_eff
                     * cfg.n_heads * (cfg.d_head or 0))
    # causal attention FLOPs for train/prefill (not in 6ND)
    if cell.kind in ("train", "prefill") and cfg.n_heads and cfg.attn_kind != "none":
        S_eff = min(cell.seq_len, cfg.sliding_window or cell.seq_len)
        mult = 3.0 if cell.kind == "train" else 1.0  # fwd+bwd
        base += mult * 2.0 * 2.0 * tokens * S_eff / 2 * cfg.n_heads \
            * (cfg.d_head or 0) / 1.0
    return base


def compute_roofline(cfg: ModelConfig, cell: ShapeCell, *,
                     per_device_flops: float, per_device_bytes: float,
                     per_device_coll_bytes: float, chips: int,
                     total_params: float) -> Roofline:
    compute_s = per_device_flops / PEAK_FLOPS
    memory_s = per_device_bytes / HBM_BW
    collective_s = per_device_coll_bytes / LINK_BW
    mf = model_flops(cfg, cell, total_params)
    hlo_total = per_device_flops * chips
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=mf, hlo_flops_total=hlo_total,
        useful_ratio=mf / hlo_total if hlo_total else 0.0,
        bottleneck=bottleneck,
    )
