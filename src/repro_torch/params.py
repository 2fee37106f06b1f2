"""Weight bridge: the reference's `init_lm` pytree -> the port's params.

The reference (`repro.models.transformer.init_lm`) returns a nested tree
in which `blocks` is a tuple over `cfg.block_pattern` whose leaves are
stacked on a leading `n_blocks` axis, `tail` is a tuple of unstacked
layers, `embed.table` and `final_norm.scale` sit beside them, and
`lm_head` is present only when embeddings are untied. The port keeps one
dict per layer (`models/transformer.py`), so this is the one place where a
layout changes: the blocks are unstacked per layer. Matrices keep the
reference's `(d_in, d_out)` layout.

Every leaf goes to `cfg.parameter_dtype` except those the reference's init
keeps in float32 whatever the parameter dtype: the RG-LRU's gate biases and
Lambda (`rglru.F32_LEAVES`, from `init_rglru_block`) and Mamba2's A_log and
dt_bias (`mamba2.F32_LEAVES`, from `init_mamba2`). The rule is the init's,
not the numpy leaf's dtype.

The caller hands the tree over as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``); this module imports no JAX.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.models import mamba2 as M2
from repro_torch.models import rglru as RG
from repro_torch.models import transformer as T

Path = Tuple
# float32 leaves, by the name of the mixer that holds them
F32_LEAVES = {"rglru": RG.F32_LEAVES, "mamba": M2.F32_LEAVES}


def _flatten(tree, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (i,)))
        return out
    return {prefix: np.asarray(tree)}


def _leaves(shapes, prefix: Path = ()):
    """(path, shape) for every leaf of a `transformer.param_shapes` dict."""
    for k, v in shapes.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree: dict, path: Path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def params_from_jax(tree, cfg, device="cuda") -> dict:
    """Convert the reference's parameter tree (numpy leaves) into the
    port's params on `device`, in `cfg.parameter_dtype` (the RG-LRU's and
    Mamba2's float32 leaves stay float32). Raises ValueError on a missing
    leaf, a shape mismatch, or any leaf left unused."""
    flat = _flatten(tree)
    used = set()

    def take(path: Path, shape, index=None) -> torch.Tensor:
        if path not in flat:
            raise ValueError(f"reference tree has no leaf {'/'.join(map(str, path))}")
        a = flat[path]
        used.add(path)
        if index is not None:
            if a.ndim == 0 or a.shape[0] != cfg.n_blocks:
                raise ValueError(f"{'/'.join(map(str, path))}: leading axis "
                                 f"{a.shape[:1]} != n_blocks {cfg.n_blocks}")
            a = a[index]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{'/'.join(map(str, path))}: shape "
                             f"{tuple(a.shape)}, expected {tuple(shape)}")
        if a.dtype.name == "bfloat16":        # ml_dtypes; torch can't wrap it
            a = a.astype(np.float32)
        f32 = len(path) >= 2 \
            and path[-1] in F32_LEAVES.get(path[-2], ())
        dtype = torch.float32 if f32 else cfg.parameter_dtype
        return torch.tensor(a, device=device, dtype=dtype)

    shapes = T.param_shapes(cfg)
    layer_shapes = shapes.pop("layers")
    out: dict = {}
    for path, shape in _leaves(shapes):
        _set(out, path, take(path, shape))
    n_pat = len(cfg.block_pattern)
    n_scan = cfg.n_blocks * n_pat
    out["layers"] = []
    for li, lshapes in enumerate(layer_shapes):
        layer: dict = {}
        for sub, shape in _leaves(lshapes):
            if li < n_scan:
                t = take(("blocks", li % n_pat) + sub, shape, li // n_pat)
            else:
                t = take(("tail", li - n_scan) + sub, shape)
            _set(layer, sub, t)
        out["layers"].append(layer)
    unused = sorted("/".join(map(str, p)) for p in set(flat) - used)
    if unused:
        raise ValueError(f"reference leaves left unused: {unused}")
    return out
