"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention, 1 attn per 2 recurrent (pattern
r,r,a x12 + r,r tail = 38 layers), window 2048. [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"),
    tail_pattern=("rglru", "rglru"),
    window=2048,
    rglru=RGLRUConfig(lru_width=4096, d_conv=4),
    tie_embeddings=True, act="gelu", rope_theta=10_000.0,
    source="[arXiv:2402.19427]",
)
