"""Whisper-small [arXiv:2212.04356; unverified] — enc-dec, conv frontend
STUBBED (input_specs feeds precomputed frame embeddings). Assignment: 12L
d_model=768 12H (kv=12) d_ff=3072 vocab=51865."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec",
        n_layers=12, n_encoder_layers=12,
        d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
        n_heads_padded=16, n_kv_heads_padded=16,  # TP-16 masked padding
        d_ff=3072, vocab=51865,
        mlp_kind="gelu", norm_kind="layernorm", use_rope=False,
        tie_embeddings=True,
        q_chunk=512, kv_chunk=512,
        remat="block", optimizer="adamw",
    )
