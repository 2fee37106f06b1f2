from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, REGISTRY, get, reduce_config

__all__ = ["ARCH_IDS", "ModelConfig", "REGISTRY", "get", "reduce_config"]
