"""granite-4.0-h-small [hybrid] — 40L d_model=4096: 36 Mamba2 layers (128
heads of 64, d_state 128, one group, conv 4) and 4 NoPE GQA layers (32/8
heads of 128) at layers 5, 15, 25, 35; every layer ends in an MoE FFN of
72 experts top-10 (width 768) plus a shared expert of 1536; vocab=100352,
tied; multipliers embedding 12, attention 1/128, residual 0.22, logits
1/16. [hf:ibm-granite/granite-4.0-h-small]

Port only (the reference registers no such arch): all 72 experts held, the
published model whole. The published SSD chunk is 256; the chunk is a
choice of how the scan is computed, not of what it computes (the SSD
kernel picks its own). The MoE keeps the port's GShard capacity (1.25);
the published model is dropless."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="granite-4.0-h-small", family="hybrid",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab_size=100352,
    block_pattern=("ssm",) * 5 + ("attn",) + ("ssm",) * 4,
    moe=MoEConfig(n_experts=72, top_k=10, expert_d_ff=768,
                  capacity_factor=1.25, shared_d_ff=1536),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    ssm_ffn=True, nope=True, embedding_multiplier=12.0,
    attention_multiplier=0.0078125, residual_multiplier=0.22,
    logits_scaling=16.0, norm_eps=1e-5, tie_embeddings=True, act="silu",
    source="[hf:ibm-granite/granite-4.0-h-small]",
)
