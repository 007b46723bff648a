"""Llama-4 Scout 17B-active/16E [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified] — MoE 16e top-1 + 1 shared expert; early-fusion multimodal is out
of scope (text backbone only, noted in DESIGN.md). Assignment: 48L
d_model=5120 40H (kv=8) d_ff=8192 vocab=202048."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        n_heads_padded=48,  # TP-16 padding: 8 output-masked dead heads
        d_head=128, d_ff=0, vocab=202048,
        mlp_kind="moe", n_experts=16, top_k=1, n_shared_experts=1,
        d_ff_expert=8192,
        rope_theta=500000.0,
        q_chunk=2048, kv_chunk=2048,
        train_microbatches=2,
        remat="block", fsdp=True, seq_shard=True, optimizer="adamw",
    )
