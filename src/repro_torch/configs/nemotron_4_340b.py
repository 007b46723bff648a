"""Nemotron-4 340B [arXiv:2402.16819; unverified] — dense GQA with
squared-ReLU MLP. Assignment: 96L d_model=18432 96H (kv=8) d_ff=73728
vocab=256000."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_head=192,
        d_ff=73728, vocab=256000,
        mlp_kind="relu2",
        train_microbatches=8,
        remat="block", fsdp=True, seq_shard=True, optimizer="adafactor",
    )
