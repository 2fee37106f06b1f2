"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512/expert
vocab=49155, MoE 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=0, vocab_size=49155,
    moe=MoEConfig(n_experts=32, top_k=8, expert_d_ff=512,
                  capacity_factor=1.25),
    tie_embeddings=True, act="silu", rope_theta=10_000.0,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base]",
)
