"""DeepSeek-V2 236B [arXiv:2405.04434; hf] — MoE 160e top-6 (+2 shared), MLA
kv_lora=512. Assignment: 60L d_model=5120 128H d_ff(expert)=1536 vocab=102400.
Simplification noted in DESIGN.md: all layers MoE (the real model's first
layer is dense)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=0, vocab=102400,
        attn_kind="mla", q_lora=1536, kv_lora=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, d_head=192,
        mlp_kind="moe", n_experts=160, top_k=6, n_shared_experts=2,
        d_ff_expert=1536,
        rope_theta=10000.0,
        train_microbatches=4,
        remat="block", fsdp=True, seq_shard=True, optimizer="adamw",
    )
