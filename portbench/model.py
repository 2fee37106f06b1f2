"""The system under test's side of a configuration: its `ModelConfig`
built from the configuration file's `model` section, and its parameter
dict as views of the benchmark's weights (`weights.make`), checked leaf
by leaf against the program's own `param_shapes`."""
from __future__ import annotations

from typing import Dict

import torch


def model_config(m: dict):
    """The program's `ModelConfig` for the sizes as run."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    kw = {k: v for k, v in m.items() if k != "moe"}
    moe = m.get("moe")
    return ModelConfig(**kw, moe=MoEConfig(**moe) if moe else None)


def program_params(w: Dict[str, torch.Tensor], m: dict, cfg) -> dict:
    """The program's parameter layout over the benchmark's tensors (views,
    no copies)."""
    from repro_torch.models.transformer import param_shapes
    layers = []
    for l in range(m["n_layers"]):
        if m.get("moe"):
            ffn = {"router": w["router"][l], "w_gate": w["moe_gate"][l],
                   "w_up": w["moe_up"][l], "w_down": w["moe_down"][l]}
        else:
            ffn = {"w_gate": w["w_gate"][l], "w_up": w["w_up"][l],
                   "w_down": w["w_down"][l]}
        layers.append({"norm1": {"scale": w["norm1"][l]},
                       "attn": {n: w[n][l] for n in ("wq", "wk", "wv", "wo")},
                       "norm2": {"scale": w["norm2"][l]}, "ffn": ffn})
    params = {"embed": {"table": w["embed"]}, "layers": layers,
              "final_norm": {"scale": w["final_norm"]}}
    if not m["tie_embeddings"]:
        params["lm_head"] = w["lm_head"]
    _check(params, param_shapes(cfg), "params")
    return params


def _check(got, want, where: str):
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{where}: keys {sorted(got)} against the "
                             f"program's {sorted(want)}")
        for k in want:
            _check(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        if len(got) != len(want):
            raise ValueError(f"{where}: {len(got)} entries, program "
                             f"{len(want)}")
        for i, (g, s) in enumerate(zip(got, want)):
            _check(g, s, f"{where}[{i}]")
    elif tuple(got.shape) != tuple(want):
        raise ValueError(f"{where}: {tuple(got.shape)} against the "
                         f"program's {tuple(want)}")
