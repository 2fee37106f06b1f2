"""Model-family registry: maps a config object to init/apply callables (the
reference's `repro.models.registry`).

The sweep engine's tasks reference models only through this registry, so a
TaskSpec is fully declarative (the paper's "parameters used to train the
model" document) and workers on any host can rebuild the computation. The
init functions take a `torch.Generator` where the reference's take a
`jax.random` key.
"""
from __future__ import annotations

from repro_torch.configs.base import MLPConfig, ModelConfig
from repro_torch.models import dnn as _dnn
from repro_torch.models import transformer as _tf


def init_fn(cfg):
    if isinstance(cfg, MLPConfig):
        return _dnn.init_dnn
    if isinstance(cfg, ModelConfig):
        return _tf.init_lm
    raise TypeError(type(cfg))


def forward_fn(cfg):
    if isinstance(cfg, MLPConfig):
        return _dnn.forward_dnn
    if isinstance(cfg, ModelConfig):
        return _tf.forward_train
    raise TypeError(type(cfg))
