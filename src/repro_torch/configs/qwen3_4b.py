"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8, head_dim=128) d_ff=9728
vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True, act="silu", rope_theta=1_000_000.0,
    long_context_window=4096,
    source="[hf:Qwen/Qwen3-8B]",
)
