"""Llama-3 405B [arXiv:2407.21783; unverified] — dense GQA, 128k vocab.
Assignment: 126L d_model=16384 128H (kv=8) d_ff=53248 vocab=128256."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_head=128,
        d_ff=53248, vocab=128256,
        rope_theta=500000.0,
        train_microbatches=8,
        remat="block", fsdp=True, seq_shard=True, optimizer="adafactor",
    )
