"""seamless-m4t-large-v2 [audio] — enc-dec backbone, 24L each side,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206. The speech frontend
(mel + conv feature extractor) is a stub per the carve-out: the encoder
consumes precomputed frame embeddings (B, S_frames, d_model).
[arXiv:2308.11596]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2", family="audio",
    n_layers=24, n_enc_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206,
    embed_stub=False,            # encoder input is the stub, not a prefix
    mlp_gated=False,             # NLLB-style 2-matrix ReLU FFN
    tie_embeddings=True, act="relu", rope_theta=10_000.0,
    long_context_window=4096,
    source="[arXiv:2308.11596]",
)
