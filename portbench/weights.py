"""The benchmark's weights: drawn from `--seed` on the device, in the
dtype they are served in, one call per kind of tensor that the model's
family names (`shapes`: for a decoder one stacked tensor per kind of
matrix for all layers), in the sorted order of their names, so set-up
makes a few large draws rather than one per leaf. Both sides read these
same tensors: the program through `model.program_params` (views in its
layout), the reference directly."""
from __future__ import annotations

from types import ModuleType
from typing import Dict, Optional

import torch

from portbench import spec

_DT = {"bfloat16": torch.bfloat16, "float16": torch.float16,
       "float32": torch.float32}


def make(m: dict, seed: int, device,
         family: Optional[ModuleType] = None) -> Dict[str, torch.Tensor]:
    """Every weight of the model `m`, from `seed`, on `device`: each
    tensor of `family.shapes(m)` from its `family.distribution`. The
    family is the configuration's (`spec.Cell.family`); a caller that
    names none, such as `tools/probe_regions.py`, gets the decoder's."""
    if family is None:
        family = spec.family("decoder")
    dt = _DT[m["param_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    out = {}
    for name, shape in sorted(family.shapes(m).items()):
        kind, *args = family.distribution(name, shape)
        if kind == "normal":
            t = torch.randn(shape, generator=gen, device=device, dtype=dt)
            t.mul_(args[0])
        elif kind == "uniform":
            lo, hi = args
            t = torch.rand(shape, generator=gen, device=device, dtype=dt)
            t.mul_(hi - lo).add_(lo)
        else:
            raise ValueError(f"{name}: no distribution {kind!r}")
        out[name] = t
    return out
