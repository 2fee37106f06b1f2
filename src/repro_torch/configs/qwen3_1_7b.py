"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8, head_dim=128)
d_ff=6144 vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True, act="silu", rope_theta=1_000_000.0,
    long_context_window=4096,
    source="[hf:Qwen/Qwen3-8B]",
)
