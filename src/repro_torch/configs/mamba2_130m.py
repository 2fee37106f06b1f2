"""mamba2-130m [ssm] — 24L d_model=768, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280,
    block_pattern=("ssm",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    tie_embeddings=True,
    source="[arXiv:2405.21060]",
)
