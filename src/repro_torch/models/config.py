"""Model configuration for the 10-architecture zoo (a copy of the
reference's ``models/config.py``).

One frozen dataclass covers every family (dense / MoE / SSM / hybrid /
enc-dec / VLM); arch constructors live in repro_torch.configs.<id>. All
sizes are the *exact* published configs from the assignment table;
`reduced()` derives the CPU smoke-test variant of the same family.  The
port keeps its own copy so that it imports nothing of the reference
package; every field, ``n_params`` and ``reduced`` are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None     # default d_model // n_heads
    # TP head padding: lift H (and KV) to a multiple of the model axis with
    # output-masked dead heads (zero gradient, function-preserving) so
    # attention shards instead of replicating. 0 = disabled.
    n_heads_padded: int = 0
    n_kv_heads_padded: int = 0
    # --- attention flavor ---
    attn_kind: str = "gqa"           # gqa | mla | none
    qk_norm: bool = False            # qwen3
    use_rope: bool = True            # whisper uses absolute positions instead
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # hymba SWA
    # --- MLP flavor ---
    mlp_kind: str = "swiglu"         # swiglu | relu2 | gelu | moe
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    lp_capacity: bool = False        # paper-technique LP router (opt-in)
    # --- MLA (deepseek-v2) ---
    kv_lora: int = 0
    q_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (mamba1) ---
    d_inner: int = 0
    ssm_state: int = 0
    # the CPU's scan: assoc (torch doubling scan) | kernel (the CUDA
    # kernel's plain version); on the card the scan is always the kernel
    ssm_impl: str = "assoc"
    conv_dim: int = 4
    dt_rank: int = 0
    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    # --- VLM ---
    n_patches: int = 0               # stub patch-embedding count
    # --- norm / misc ---
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    tie_embeddings: bool = False
    # --- numerics & memory ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "block"             # none | block (checkpoint each layer)
    q_chunk: int = 1024
    kv_chunk: int = 1024
    # --- parallelism ---
    train_microbatches: int = 1      # gradient-accumulation chunks per step
    fsdp: bool = False               # shard params/opt-state over 'data' too
    seq_shard: bool = False          # sequence-parallel residual stream
    optimizer: str = "adamw"         # adamw | adafactor

    def __post_init__(self):
        if self.d_head is None and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        return (self.vocab + 127) // 128 * 128

    @property
    def d_attn(self) -> int:
        return self.n_heads * (self.d_head or 0)

    def n_params(self) -> float:
        """Analytic parameter count (embeddings included, biases ignored)."""
        D, F, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        emb = V * D * (1 if self.tie_embeddings else 2)
        per_layer = 0.0
        if self.attn_kind == "gqa":
            hd = self.d_head
            per_layer += D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd \
                + self.n_heads * hd * D
        elif self.attn_kind == "mla":
            qh = self.qk_nope_dim + self.qk_rope_dim
            per_layer += D * self.q_lora + self.q_lora * self.n_heads * qh
            per_layer += D * (self.kv_lora + self.qk_rope_dim)
            per_layer += self.kv_lora * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
            per_layer += self.n_heads * self.v_head_dim * D
        if self.mlp_kind == "swiglu":
            per_layer += 3 * D * F
        elif self.mlp_kind in ("relu2", "gelu"):
            per_layer += 2 * D * F
        elif self.mlp_kind == "moe":
            fe = self.d_ff_expert
            per_layer += self.n_experts * 3 * D * fe
            per_layer += self.n_shared_experts * 3 * D * fe
            per_layer += D * self.n_experts  # router
        if self.family in ("ssm", "hybrid"):
            di, st = self.d_inner, self.ssm_state
            ssm = D * 2 * di + di * self.conv_dim + di * (self.dt_rank + 2 * st) \
                + self.dt_rank * di + di * st + di + di * D
            per_layer += ssm
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            hd = self.d_head
            enc_layer = (2 + 2) * D * self.n_heads * hd / 2 + 2 * D * F  # approx
            per_layer += D * self.n_heads * hd + self.n_heads * hd * D  # cross attn kq/vo
            emb += self.n_encoder_layers * enc_layer
        return emb + L * per_layer

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        def shrink(v, lo, div=4):
            return max(lo, v // div) if v else 0
        return dataclasses.replace(
            self,
            n_layers=2,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_head=16 if self.n_heads else None,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=8 if self.n_experts else 0,
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            d_ff_expert=32 if self.d_ff_expert else 0,
            kv_lora=16 if self.kv_lora else 0,
            q_lora=24 if self.q_lora else 0,
            qk_nope_dim=16 if self.qk_nope_dim else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            d_inner=128 if self.d_inner else 0,
            ssm_state=8 if self.ssm_state else 0,
            dt_rank=8 if self.dt_rank else 0,
            sliding_window=32 if self.sliding_window else None,
            n_patches=8 if self.n_patches else 0,
            q_chunk=32,
            kv_chunk=32,
            train_microbatches=1,
            n_heads_padded=0,
            n_kv_heads_padded=0,
            fsdp=False,
            seq_shard=False,
            dtype="float32",
            param_dtype="float32",
            remat="none",
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (arch x input-shape) dry-run cell."""
    name: str           # train_4k | prefill_32k | decode_32k | long_500k
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = (
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
