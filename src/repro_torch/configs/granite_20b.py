"""Granite-20B code [arXiv:2405.04324; hf] — MQA (kv=1). Assignment: 52L
d_model=6144 48H (kv=1) d_ff=24576 vocab=49152. The assignment tags it
llama-arch; the published 20.1B total is only consistent with the
gpt-bigcode-style 2-matrix GELU MLP (a 3-matrix SwiGLU gives 28B), so the
MLP is GELU while norm/rope follow the llama recipe (noted in DESIGN.md)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
        d_ff=24576, vocab=49152,
        mlp_kind="gelu",
        train_microbatches=2,
        remat="block", seq_shard=True, optimizer="adamw",
    )
