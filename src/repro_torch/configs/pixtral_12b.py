"""pixtral-12b [vlm] — mistral-nemo decoder (40L d_model=5120 32H kv=8
d_ff=14336 vocab=131072) consuming pixtral-ViT patch embeddings. The vision
encoder + projector are a stub per the carve-out: the model takes
precomputed patch embeddings (B, n_patches, d_model) as a prefix.
[hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    embed_stub=True,
    tie_embeddings=False, act="silu", rope_theta=1_000_000.0,
    long_context_window=4096,
    source="[hf:mistralai/Pixtral-12B-2409]",
)
