"""Path-keyed numpy checkpoints in the reference's format
(`repro.checkpoint.checkpoint`), so a file written by either package
restores in the other.

A tree (nested dicts, lists, tuples and NamedTuples of tensors or numpy
arrays) is flattened to "/"-joined keys: a dict key as it is, a sequence
item as "[i]", a NamedTuple field by its name, e.g.
"opt_state/mu/blocks/[0]/attn/wq". The leaves go into
`step_XXXXXXXX.proc{p}.npz` beside `step_XXXXXXXX.manifest.json` (step,
keys, dtypes, shapes). `np.savez` stores a bfloat16 leaf as raw 2-byte
records (`|V2`), as it stores the reference's `ml_dtypes` leaves; reading
goes by the manifest's dtype, so no `ml_dtypes` is needed. The process
index is 0 until the port is distributed (ROADMAP Queue 1 item 16).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.sharding import rules as R
from repro_torch.sharding import spmd

_TORCH_DTYPES = {"bfloat16": torch.bfloat16}


def _items(tree, prefix: str):
    """(key, leaf) pairs in the reference's key scheme, in the order of
    torch's pytree leaves (`restore_checkpoint` relies on it)."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, join(k))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _items(v, join(k))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, join(f"[{i}]"))
    elif tree is not None:
        yield prefix, tree


def process_index() -> int:
    """This process's rank in the initialized process group, else 0."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _to_numpy(leaf):
    """(numpy array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        if spmd.is_dtensor(leaf):             # gathered: the whole leaf
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    if not a.flags.c_contiguous:
        a = a.copy()
    if dtype in _TORCH_DTYPES:          # stored as raw 2-byte records
        return torch.from_numpy(a.view(np.int16)).view(_TORCH_DTYPES[dtype])
    return torch.from_numpy(a)


def _paths(ckpt_dir: str, step: int):
    base = os.path.join(ckpt_dir, f"step_{step:08d}")
    return f"{base}.proc{process_index()}.npz", f"{base}.manifest.json"


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat, dtypes = {}, {}
    for key, leaf in _items(tree, ""):
        flat[key], dtypes[key] = _to_numpy(leaf)
    path, manifest_path = _paths(ckpt_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    manifest = {"step": step, "keys": sorted(flat), "dtypes": dtypes,
                "shapes": {k: list(v.shape) for k, v in flat.items()}}
    tmp = f"{manifest_path}.{process_index()}.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, manifest_path)    # every process writes the same one
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.manifest\.json$", f))]
    return max(steps) if steps else None


def load_flat(ckpt_dir: str, step: int) -> dict:
    """Every leaf of a checkpoint as a CPU tensor in its stored dtype, by
    key: from this process's file, or process 0's where this process wrote
    none (a checkpoint written by one process restores onto several; every
    file holds the whole tree)."""
    path, manifest_path = _paths(ckpt_dir, step)
    if not os.path.exists(path):
        path = os.path.join(ckpt_dir, f"step_{step:08d}.proc0.npz")
    with open(manifest_path) as f:
        dtypes = json.load(f)["dtypes"]
    with np.load(path) as data:
        return {k: _to_torch(data[k], dtypes[k]) for k in data.files}


def restore_checkpoint(ckpt_dir: str, step: int, like: Any,
                       device=None, shardings: Any = None,
                       mesh=None) -> Any:
    """Restore into the structure of ``like`` (values ignored): the same
    nesting of dicts, lists, tuples and NamedTuples, with CPU-loaded
    tensors moved to `device`; by default each leaf goes to the device of
    its template leaf (the CPU for a template leaf that is no tensor), as
    the reference restores onto its default device. Raises KeyError on a
    key the file lacks; keys ``like`` does not have are left out, as the
    reference leaves them.

    ``shardings``: a tree of the same structure whose leaves are DTensor
    placements (a sequence of Placement objects) or specs
    (`sharding.rules`), with ``mesh`` the DeviceMesh (by default the mesh
    of the first DTensor leaf of ``like``): each leaf is distributed with
    it onto the mesh's device (`distribute_tensor`; every process read the
    whole leaf, so no data moves between them), as the reference
    device_puts each leaf with its sharding."""
    flat = load_flat(ckpt_dir, step)
    _, spec = tree_flatten(like)

    def target(leaf):
        if device is not None:
            return device
        return leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
    items = list(_items(like, ""))
    if shardings is None:
        return tree_unflatten([flat[k].to(target(leaf)) for k, leaf in items],
                              spec)
    from torch.distributed.tensor import Placement, distribute_tensor
    if mesh is None:
        mesh = next(leaf.device_mesh for _, leaf in items
                    if hasattr(leaf, "device_mesh"))
    lay = list(_matching(like, shardings))
    if len(lay) != len(items):
        raise ValueError(f"{len(items)} leaves, {len(lay)} shardings")
    out = []
    for (k, _), s in zip(items, lay):
        pl = tuple(s) if s and all(isinstance(p, Placement) for p in s) \
            else R.to_placements(mesh, s)
        out.append(distribute_tensor(flat[k].to(mesh.device_type), mesh, pl,
                                     src_data_rank=None))
    return tree_unflatten(out, spec)


def _matching(like, shardings):
    """The entry of `shardings` at each leaf of `like`, in `_items`'
    order: `shardings` has like's nesting down to like's leaves, where it
    holds a spec tuple or a sequence of placements."""
    if isinstance(like, dict):
        for k, v in like.items():
            yield from _matching(v, shardings[k])
    elif isinstance(like, (tuple, list)):
        for v, s in zip(like, shardings):
            yield from _matching(v, s)
    elif like is not None:
        yield shardings
