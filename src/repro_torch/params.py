"""Weight bridge between the reference's `init_lm` pytree and the port's
params, both ways, and from the reference's `init_dnn` MLPs (one, or a
population stacked on a leading axis) to the port's.

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
``jax.tree.map(np.asarray, params)``) or as tensors (a checkpoint restored
with `checkpoint.restore_checkpoint`); this module imports no JAX.

The other way, `jax_layout` restacks the port's per-layer dicts (params,
or any tree of their shape: gradients, optimizer moments) into the
reference's layout, and `params_to_jax` gives that tree as numpy arrays.
The trainer writes its checkpoints in that layout.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.configs.base import MLPConfig
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
    return {prefix: tree if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


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


def _tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype, copy=True)
    if a.dtype.name == "bfloat16":        # ml_dtypes; torch can't wrap it
        a = a.astype(np.float32)
    return torch.tensor(a, device=device, dtype=dtype)


def _check_shape(a, path: Path, shape):
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{'/'.join(map(str, path))}: shape "
                         f"{tuple(a.shape)}, expected {tuple(shape)}")


def _check_all_used(flat, used):
    unused = sorted("/".join(map(str, p)) for p in set(flat) - used)
    if unused:
        raise ValueError(f"reference leaves left unused: {unused}")


def _missing(path: Path):
    return ValueError(f"reference tree has no leaf {'/'.join(map(str, path))}")


def params_from_jax(tree, cfg, device="cuda") -> dict:
    """Convert the reference's parameter tree (numpy leaves) into the
    port's params on `device`, in `cfg.parameter_dtype` (the RG-LRU's and
    Mamba2's float32 leaves stay float32). `cfg` is a `ModelConfig` or the
    paper's `MLPConfig` (`_mlp_params_from_jax`: one MLP or a stacked
    population). Raises ValueError on a
    missing leaf, a shape mismatch, or any leaf left unused."""
    if isinstance(cfg, MLPConfig):
        return _mlp_params_from_jax(tree, cfg, device)
    flat = _flatten(tree)
    used = set()

    def take(path: Path, shape, index=None) -> torch.Tensor:
        if path not in flat:
            raise _missing(path)
        a = flat[path]
        used.add(path)
        if index is not None:
            if a.ndim == 0 or a.shape[0] != cfg.n_blocks:
                raise ValueError(f"{'/'.join(map(str, path))}: leading axis "
                                 f"{a.shape[:1]} != n_blocks {cfg.n_blocks}")
            a = a[index]
        _check_shape(a, path, shape)
        f32 = len(path) >= 2 \
            and path[-1] in F32_LEAVES.get(path[-2], ())
        return _tensor(a, torch.float32 if f32 else cfg.parameter_dtype,
                       device)

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
    _check_all_used(flat, used)
    return out


def _mlp_params_from_jax(tree, cfg: MLPConfig, device="cuda") -> dict:
    """The reference's `init_dnn` tree ({"layers": ({"w": (d_in, d_out),
    "b": (d_out,)}, ...)}, the port's layout too) as the port's params on
    `device` in `cfg.parameter_dtype`; or a population of K such trees
    stacked on a leading axis of every leaf (`jax.vmap(init_dnn)`'s), told
    by the first weight's rank, kept stacked for `core.population`."""
    flat = _flatten(tree)
    first = ("layers", 0, "w")
    if first not in flat:
        raise _missing(first)
    lead = tuple(flat[first].shape[:1]) if flat[first].ndim == 3 else ()
    sizes = (cfg.n_features,) + tuple(cfg.hidden_sizes) + (cfg.n_classes,)
    layers = []
    for i in range(len(sizes) - 1):
        layer = {}
        for name, shape in (("w", (sizes[i], sizes[i + 1])),
                            ("b", (sizes[i + 1],))):
            path = ("layers", i, name)
            if path not in flat:
                raise _missing(path)
            _check_shape(flat[path], path, lead + shape)
            layer[name] = _tensor(flat[path], cfg.parameter_dtype, device)
        layers.append(layer)
    _check_all_used(flat, {("layers", i, n) for i in range(len(layers))
                           for n in ("w", "b")})
    return {"layers": tuple(layers)}


def jax_layout(params, cfg) -> dict:
    """The port's params, or any tree of their shape (gradients, AdamW's
    moments), in the reference's layout, leaves still tensors: "layers"
    becomes `blocks`, a tuple over `cfg.block_pattern` of layer dicts
    stacked on a leading n_blocks axis (absent when there are no blocks),
    and `tail`, a tuple of the remaining layers; the other entries stay as
    they are, in their order (`port_layout` restores it)."""
    n_pat = len(cfg.block_pattern)
    n_scan = cfg.n_blocks * n_pat
    out = {}
    for k, v in params.items():
        if k != "layers":
            out[k] = v
            continue
        if cfg.n_blocks > 0:
            out["blocks"] = tuple(
                tree_map(lambda *xs: torch.stack(xs),
                         *(v[b + i] for b in range(0, n_scan, n_pat)))
                for i in range(n_pat))
        out["tail"] = tuple(v[n_scan:])
    return out


def port_layout(tree, cfg) -> dict:
    """The inverse of `jax_layout`: the blocks unstacked per layer into
    "layers", every leaf in its own dtype and on its own device (unlike
    `params_from_jax`, which casts to the parameter dtype: optimizer
    moments stay float32)."""
    n_pat = len(cfg.block_pattern)
    out = {}
    for k, v in tree.items():
        if k == "blocks":
            out["layers"] = [tree_map(lambda a: a[b], v[i])
                             for b in range(cfg.n_blocks)
                             for i in range(n_pat)]
        elif k == "tail":
            out.setdefault("layers", []).extend(v)
        else:
            out[k] = v
    return out


def params_to_jax(params, cfg) -> dict:
    """The inverse of `params_from_jax`: the reference's parameter tree as
    CPU numpy arrays (bfloat16 leaves as `ml_dtypes.bfloat16`, imported
    only then)."""
    def to_numpy(t):
        t = t.detach().cpu()
        if t.dtype != torch.bfloat16:
            return t.numpy()
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return tree_map(to_numpy, jax_layout(params, cfg))
