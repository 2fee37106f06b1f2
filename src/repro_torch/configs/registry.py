"""Config registry: --arch <id> -> ModelConfig, full or reduced.

The port registers the pure-attention decoder archs, the RG-LRU hybrid
(recurrentgemma-9b) and Mamba2 (mamba2-130m), the families its models
run, and granite-moe-1b-a400m, whose MoE FFN is not ported yet: its
models raise NotImplementedError (`transformer._check_ported`), so a sweep
task on it fails forward with that error. The other MoE, enc-dec and
modality-prefix archs wait for their own slices (ROADMAP.md Queue 1).
`reduce_config` is the reference's, so a reduced config here equals the
reduced config there field for field (the parity tests rely on it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig

from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite1b
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen17b
from repro_torch.configs.qwen3_4b import CONFIG as _qwen4b
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2

REGISTRY: Dict[str, ModelConfig] = {c.arch_id: c for c in [
    _granite1b, _mamba2, _nemo, _qwen17b, _qwen4b, _rgemma, _starcoder2,
]}

ARCH_IDS = sorted(REGISTRY)


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Same family, CPU-smoke scale."""
    kw = dict(
        d_model=256, vocab_size=512, norm_eps=cfg.norm_eps,
        dtype="float32", param_dtype="float32",
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
                  head_dim=64)
    if cfg.d_ff:
        kw.update(d_ff=512)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4, top_k=2,
                                        expert_d_ff=128)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=32, head_dim=32,
                                        chunk_size=16)
    if cfg.rglru:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=256)
    if cfg.tail_pattern:
        kw["tail_pattern"] = ()
    # one block of the pattern (hybrid: 3 layers; others: 2 layers)
    kw["n_layers"] = max(2, len(cfg.block_pattern))
    if len(cfg.block_pattern) == 1:
        kw["n_layers"] = 2
    if cfg.is_encdec:
        kw["n_enc_layers"] = 2
    if cfg.window:
        kw["window"] = 16
    kw["long_context_window"] = 32
    return cfg.replace(**kw)


def get(arch_id: str, *, reduced: bool = False) -> ModelConfig:
    cfg = REGISTRY[arch_id]
    return reduce_config(cfg) if reduced else cfg
