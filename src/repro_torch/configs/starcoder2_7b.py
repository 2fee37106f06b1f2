"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, GQA + RoPE. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab_size=49152,
    mlp_gated=False,           # classic 2-matrix GELU MLP
    tie_embeddings=True, act="gelu", rope_theta=100_000.0,
    long_context_window=4096,
    source="[arXiv:2402.19173]",
)
