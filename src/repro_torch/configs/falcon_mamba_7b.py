"""Falcon-Mamba 7B [arXiv:2410.05355; unverified] — pure Mamba-1, attn-free.
Assignment: 64L d_model=4096 d_ff=0 vocab=65024 ssm_state=16."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_head=0,
        d_ff=0, vocab=65024,
        attn_kind="none", mlp_kind="none",
        d_inner=8192, ssm_state=16, conv_dim=4, dt_rank=256,
        train_microbatches=2,
        remat="block", seq_shard=True, optimizer="adamw",
    )
