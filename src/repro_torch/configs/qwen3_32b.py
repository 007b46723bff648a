"""Qwen3-32B [hf:Qwen/Qwen3-8B; hf] — dense GQA with qk-norm. Assignment:
64L d_model=5120 64H (kv=8) d_ff=25600 vocab=151936."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=25600, vocab=151936,
        qk_norm=True, rope_theta=1000000.0,
        train_microbatches=4,
        remat="block", seq_shard=True, optimizer="adamw",
    )
