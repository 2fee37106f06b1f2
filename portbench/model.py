"""The system under test's side of a configuration: its `ModelConfig`
built from the configuration file's `model` section, and its parameter
dict as views of the benchmark's weights (`weights.make`) in the layout
the configuration's family gives, checked leaf by leaf against the
program's own `param_shapes`."""
from __future__ import annotations

import dataclasses
import typing
from types import ModuleType
from typing import Dict, Optional

import torch

from portbench import spec


def model_config(m: dict):
    """The program's `ModelConfig` for the sizes as run: a nested group
    (`moe`, `ssm`, ...) becomes the sub-config its field holds, a list
    a tuple."""
    from repro_torch.configs.base import ModelConfig
    hints = typing.get_type_hints(ModelConfig)
    kw = {}
    for k, v in m.items():
        if isinstance(v, dict):
            sub = [t for t in typing.get_args(hints[k])
                   if dataclasses.is_dataclass(t)]
            v = sub[0](**v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return ModelConfig(**kw)


def program_params(w: Dict[str, torch.Tensor], m: dict, cfg,
                   family: Optional[ModuleType] = None) -> dict:
    """The program's parameter layout over the benchmark's tensors (views,
    no copies), as the family lays it out (the decoder's where none is
    named, as in `weights.make`)."""
    from repro_torch.models.transformer import param_shapes
    if family is None:
        family = spec.family("decoder")
    params = family.program_params(w, m, cfg)
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
