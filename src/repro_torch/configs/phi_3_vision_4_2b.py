"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct; hf] —
phi3-mini backbone + CLIP frontend STUBBED (input_specs feeds precomputed
patch embeddings, n_patches=256). Assignment: 32L d_model=3072 32H (kv=32)
d_ff=8192 vocab=32064."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
        d_ff=8192, vocab=32064,
        n_patches=256,
        remat="block", seq_shard=True, optimizer="adamw",
    )
