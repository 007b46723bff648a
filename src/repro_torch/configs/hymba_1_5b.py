"""Hymba-1.5B [arXiv:2411.13676; hf] — parallel attention+mamba heads.
Assignment: 32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001 ssm_state=16.
Simplifications (DESIGN.md): sliding-window attention in every layer (the
real model keeps 3 global-attention layers); head outputs mean-fused (the
real model learns per-path scalings)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
        d_ff=5504, vocab=32001,
        sliding_window=1024,
        d_inner=3200, ssm_state=16, conv_dim=4, dt_rank=100,
        q_chunk=256, kv_chunk=512,
        train_microbatches=2,
        remat="block", seq_shard=True, optimizer="adamw",
    )
