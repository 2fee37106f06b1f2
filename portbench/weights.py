"""The benchmark's weights: drawn from `--seed` on the device, in the
dtype they are served in, one call per kind of matrix for all layers
(stacked on a leading layer axis), so set-up makes a few large draws
rather than one per leaf. Both sides read these same tensors: the
program through `model.program_params` (views in its layout), the
reference directly.

Distributions are the JAX package's initialisers: matrices uniform in
+-1/sqrt(d_in), the MoE router in +-0.02, the embedding N(0, 0.02^2).
Norm scales, which that initialiser sets to zero (a scale of 1, stored
as 1 + w), are drawn uniform in +-0.1 here so that the comparison also
covers them."""
from __future__ import annotations

import math
from typing import Dict

import torch

_DT = {"bfloat16": torch.bfloat16, "float16": torch.float16,
       "float32": torch.float32}
NORM_SCALE = 0.1


def shapes(m: dict) -> Dict[str, tuple]:
    L, d, V = m["n_layers"], m["d_model"], m["vocab_size"]
    nh, nkv = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // nh
    out = {"embed": (V, d), "final_norm": (d,), "norm1": (L, d),
           "norm2": (L, d), "wq": (L, d, nh * hd), "wk": (L, d, nkv * hd),
           "wv": (L, d, nkv * hd), "wo": (L, nh * hd, d)}
    if not m["tie_embeddings"]:
        out["lm_head"] = (d, V)
    moe = m.get("moe")
    if moe:
        E, f = moe["n_experts"], moe["expert_d_ff"]
        out.update(router=(L, d, E), moe_gate=(L, E, d, f),
                   moe_up=(L, E, d, f), moe_down=(L, E, f, d))
    else:
        f = m["d_ff"]
        out.update(w_gate=(L, d, f), w_up=(L, d, f), w_down=(L, f, d))
    return out


def _scale(name: str, shape: tuple) -> float:
    if name == "router":
        return 0.02
    if name.startswith("norm") or name == "final_norm":
        return NORM_SCALE
    return 1.0 / math.sqrt(shape[-2])           # +-1/sqrt(d_in)


def make(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of the model `m`, from `seed`, on `device`."""
    dt = _DT[m["param_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    out = {}
    for name, shape in sorted(shapes(m).items()):
        if name == "embed":
            t = torch.randn(shape, generator=gen, device=device, dtype=dt)
            t.mul_(0.02)
        else:
            s = _scale(name, shape)
            t = torch.rand(shape, generator=gen, device=device, dtype=dt)
            t.mul_(2 * s).sub_(s)
        out[name] = t
    return out
