"""The paper's own model family: tabular MLP classifiers (the reference's
`repro.models.dnn`).

This is the network the 2015 framework sweeps (PyBrain/Keras "Dense" stacks
over CSV features). Hidden sizes and the per-layer activation cycle are the
swept design dimensions (paper findings F1 and F3).

Params: {"layers": tuple of {"w": (d_in, d_out), "b": (d_out,)}}, the
reference's tree, so its checkpoints carry over as they are. Dropout draws
its masks from a `torch.Generator` (the `key` argument), whose bits differ
from `jax.random`'s.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MLPConfig
from repro_torch.models.layers import ACTIVATIONS, dense_init


def init_dnn(gen: torch.Generator, cfg: MLPConfig):
    sizes = (cfg.n_features,) + tuple(cfg.hidden_sizes) + (cfg.n_classes,)
    pdt = cfg.parameter_dtype
    return {
        "layers": tuple(
            {"w": dense_init(gen, sizes[i], sizes[i + 1], pdt),
             "b": torch.zeros((sizes[i + 1],), dtype=pdt, device=gen.device)}
            for i in range(len(sizes) - 1)),
    }


def forward_dnn(params, cfg: MLPConfig, x, *, train: bool = False,
                key: torch.Generator = None):
    """x: (B, n_features) -> logits (B, n_classes)."""
    n = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        x = x @ lp["w"] + lp["b"]
        if i < n - 1:
            act = cfg.activations[i % len(cfg.activations)]
            x = ACTIVATIONS[act](x)
            if train and cfg.dropout > 0 and key is not None:
                keep = torch.rand(x.shape, generator=key,
                                  device=x.device) < 1 - cfg.dropout
                x = torch.where(keep, x / (1 - cfg.dropout), 0)
    return x


def dnn_loss(params, cfg: MLPConfig, batch, key=None):
    """Softmax cross-entropy on one-hot labels. batch: {"x": (B,F), "y": (B,C)}.
    Returns (loss, {"accuracy"})."""
    logits = forward_dnn(params, cfg, batch["x"], train=key is not None,
                         key=key)
    logp = F.log_softmax(logits.float(), dim=-1)
    loss = -torch.mean(torch.sum(batch["y"] * logp, dim=-1))
    acc = torch.mean((logits.argmax(-1) == batch["y"].argmax(-1)).float())
    return loss, {"accuracy": acc}
