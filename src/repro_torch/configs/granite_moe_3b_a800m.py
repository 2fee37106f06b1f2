"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert
vocab=49155, MoE 40 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=0, vocab_size=49155,
    moe=MoEConfig(n_experts=40, top_k=8, expert_d_ff=512,
                  capacity_factor=1.25),
    tie_embeddings=True, act="silu", rope_theta=10_000.0,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base]",
)
