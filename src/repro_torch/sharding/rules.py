"""Sharding rule engine: param-path patterns -> partition specs, per arch
(the reference's `repro.sharding.rules`, on torch's DeviceMesh and DTensor).

Mesh contract (launch/mesh.py): axes ("data", "model") single-pod,
("pod", "data", "model") multi-pod. "pod" and "data" jointly shard the
batch; "model" shards tensor dims. Rules are *divisibility-aware*: a dim is
only sharded when it divides evenly, so e.g. starcoder2's 36 heads fall
back to feature-dim sharding and granite-3b's 40 experts fall back to
expert-internal TP without special-casing arch names.

A spec is a tuple with one entry per tensor dim: None (replicated), a mesh
axis name, or a tuple of names (the dim split over those axes, the first
major), normalized as the reference's `PartitionSpec` normalizes its
entries (a one-name tuple is the name, an empty one None), so a spec
compares entry for entry with `tuple(P(...))`. `to_placements` turns a
spec into DTensor placements.

The rule functions take a mesh-like object: a DeviceMesh, or anything
with `mesh_dim_names` (or `axis_names`) and a shape (`shape`, or
`devices.shape`); `mesh_like` builds one without any process group.

The rules match the reference's "/"-joined param paths. The port keeps one
dict per layer where the reference stacks `blocks` on a leading n_blocks
axis: each layer leaf is given the stacked leaf's spec, computed on the
reference's path and stacked shape, minus its leading None
(`reference_path`). Caches are per layer too, their batch dim first.
"""
from __future__ import annotations

import contextlib
import re
import threading
from types import SimpleNamespace
from typing import Tuple

from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

_AMBIENT = threading.local()


# -------------------------------------------------------------- mesh helpers

def mesh_like(shape, names):
    """A mesh-like object of `shape` with axis `names`, for the spec
    functions: no devices and no process group."""
    return SimpleNamespace(mesh_dim_names=tuple(names), shape=tuple(shape))


def _axes(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _sizes(mesh) -> Tuple[int, ...]:
    shape = getattr(mesh, "shape", None)
    if shape is None:
        shape = mesh.devices.shape
    return tuple(int(s) for s in shape)


@contextlib.contextmanager
def mesh_context(mesh):
    """Make `mesh` ambient for this thread (read by `constrain`)."""
    prev = getattr(_AMBIENT, "mesh", None)
    _AMBIENT.mesh = mesh
    try:
        yield mesh
    finally:
        _AMBIENT.mesh = prev


def ambient_mesh():
    return getattr(_AMBIENT, "mesh", None)


def mesh_axis_size(mesh, name: str) -> int:
    return dict(zip(_axes(mesh), _sizes(mesh))).get(name, 1)


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _axes(mesh))


def dp_size(mesh) -> int:
    out = 1
    for a in batch_axes(mesh):
        out *= mesh_axis_size(mesh, a)
    return out


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def P(*entries) -> tuple:
    """A spec tuple, entries normalized as the reference's PartitionSpec."""
    return tuple(_entry(e) for e in entries)


def is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def to_placements(mesh, spec):
    """DTensor placements of `spec` on `mesh`: Shard(d) on every mesh dim
    that spec entry d names, else Replicate(). An entry naming several
    axes must name them in the mesh's order (major first)."""
    from torch.distributed.tensor import Replicate, Shard
    axes = _axes(mesh)
    out = [Replicate() for _ in axes]
    for d, e in enumerate(spec):
        if e is None:
            continue
        names = (e,) if isinstance(e, str) else tuple(e)
        idx = [axes.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e} is not in the mesh's axis "
                             f"order {axes}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


# -------------------------------------------------------------- constraints

def constrain(x, dims):
    """Soft sharding constraint usable inside mesh-agnostic model code.

    dims: per-dimension tag — "batch" | "model" | None, resolved against
    the ambient mesh (`mesh_context`). Returns `x` itself when there is no
    ambient mesh or `x` is no DTensor; else `x` redistributed to the spec
    (a dim is sharded only where it divides)."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    names = _axes(mesh)
    spec = []
    for i, d in enumerate(dims):
        if d == "batch":
            axes = tuple(a for a in ("pod", "data") if a in names)
            ok = axes and x.shape[i] % _axes_size(mesh, axes) == 0
            spec.append(axes if ok else None)
        elif d == "model" and "model" in names:
            ok = x.shape[i] % _axes_size(mesh, ("model",)) == 0
            spec.append("model" if ok else None)
        else:
            spec.append(None)
    placements = to_placements(x.device_mesh, P(*spec))
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def _axes_size(mesh, axes) -> int:
    out = 1
    for a in axes:
        out *= mesh_axis_size(mesh, a)
    return out


# -------------------------------------------------------------- param rules

def _spec_for(path: str, shape, cfg, mesh) -> tuple:
    """Core rule table. `path` is the /-joined pytree path of the leaf."""
    mdl = mesh_axis_size(mesh, "model")

    def shard_if(dim_size, axis="model"):
        return axis if dim_size % mdl == 0 and mdl > 1 else None

    nd = len(shape)

    # ---- embeddings: shard vocab over model (biggest single tensor).
    # embed/table is (V, d); lm_head is (d, V) — sharding lm_head's dim -2
    # would split the CONTRACTING dim and all-reduce full f32 logits.
    if path.endswith("embed/table"):
        return P(shard_if(shape[-2]), None) if nd >= 2 else P(None)
    if path.endswith("lm_head"):
        return P(None, shard_if(shape[-1])) if nd >= 2 else P(None)

    # ---- norms / scalars / small vectors: replicate
    if "norm" in path or path.endswith(("scale", "b_r", "b_i", "Lambda",
                                        "A_log", "dt_bias", "D", "conv_b",
                                        "b")):
        return P(*([None] * nd))

    # ---- MoE experts: expert-parallel if divisible, else per-expert TP
    if re.search(r"ffn/(w_gate|w_up)$", path) and cfg.moe:
        E, dff = shape[-3], shape[-1]
        if E % mdl == 0:
            return P(*([None] * (nd - 3)), "model", None, None)
        return P(*([None] * (nd - 3)), None, None, shard_if(dff))
    if path.endswith("ffn/w_down") and cfg.moe:
        E, dff = shape[-3], shape[-2]
        if E % mdl == 0:
            return P(*([None] * (nd - 3)), "model", None, None)
        return P(*([None] * (nd - 3)), None, shard_if(dff), None)
    if path.endswith("ffn/router"):
        return P(*([None] * nd))

    # ---- dense mlp / attention projections: megatron col/row split
    if re.search(r"(w_gate|w_up|wq|wk|wv|in_proj|w_x|w_gate_branch|w_r|w_i)$",
                 path):
        return P(*([None] * (nd - 2)), None, shard_if(shape[-1]))
    if re.search(r"(w_down|wo|out_proj)$", path):
        return P(*([None] * (nd - 2)), shard_if(shape[-2]), None)
    if path.endswith("conv_w"):
        return P(*([None] * (nd - 2)), None, shard_if(shape[-1]))

    return P(*([None] * nd))


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _walk(tree, prefix=()):
    """(path tuple, leaf) for every leaf, in torch pytree leaf order; a
    spec tuple is a leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)) and not is_spec(tree):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (i,))
    else:
        yield prefix, tree


def reference_path(path: tuple, cfg):
    """The reference's "/"-joined path of the port's leaf at `path`, and
    the length of the stacked axis the reference puts in front of it
    (n_blocks for a block layer, n_enc_layers for an encoder layer, 0 for
    an unstacked leaf). Layer li of the port is block li % n_pat of the
    pattern, entry li // n_pat of the stack, below n_blocks * n_pat, and a
    tail layer after."""
    n_pat = len(cfg.block_pattern)
    n_scan = cfg.n_blocks * n_pat
    if path and path[0] == "layers":
        li, sub = path[1], path[2:]
        if li < n_scan:
            head, lead = ("blocks", li % n_pat), cfg.n_blocks
        else:
            head, lead = ("tail", li - n_scan), 0
        path = head + sub
    elif path[:2] == ("encoder", "layers"):
        path, lead = ("encoder", "blocks") + path[3:], cfg.n_enc_layers
    else:
        lead = 0
    return "/".join(_key(p) for p in path), lead


def _shape(leaf):
    return tuple(leaf.shape)


def param_specs(cfg, params_shape, mesh):
    """params_shape: the port's params tree, leaves tensors (meta tensors
    do) or anything with a `.shape`. Returns the same tree of specs."""
    leaves, spec_tree = tree_flatten(params_shape)
    specs = []
    for (path, _), leaf in zip(_walk(params_shape), leaves):
        pstr, lead = reference_path(path, cfg)
        shape = _shape(leaf)
        if lead:
            s = _spec_for(pstr, (lead,) + shape, cfg, mesh)
            assert s[0] is None, (pstr, s)
            s = s[1:]
        else:
            s = _spec_for(pstr, shape, cfg, mesh)
        specs.append(s)
    return _rebuild(spec_tree, specs)


def _rebuild(spec_tree, specs):
    """The tree of `spec_tree` with `specs` as its leaves (tree_unflatten
    would take a spec tuple for a node)."""
    it = iter(specs)
    holders = tree_unflatten([object() for _ in specs], spec_tree)
    return tree_map(lambda _: next(it), holders)


# -------------------------------------------------------------- other trees

def opt_state_specs(cfg, opt_state_shape, pspecs):
    """AdamW/SGD moments mirror the param specs; step counter replicates.
    State layout: (step, moment_tree, ...) — every moment tree mirrors."""
    _, *moments = opt_state_shape
    return type(opt_state_shape)(P(), *[pspecs for _ in moments])


def _batch_leaf_spec(mesh, ndim, b):
    bax = batch_axes(mesh)
    for axes in (bax, bax[-1:],):
        size = 1
        for a in axes:
            size *= mesh_axis_size(mesh, a)
        if axes and b % size == 0:
            return P(axes, *([None] * (ndim - 1)))
    return P(*([None] * ndim))


def batch_specs(cfg, batch_shape, mesh):
    """Token/label/embeds batches: batch dim over ("pod","data") when it
    divides, else fall back to "data", else replicate."""
    return {k: _batch_leaf_spec(mesh, len(_shape(v)), _shape(v)[0])
            for k, v in batch_shape.items()}


def _cache_batch_entry(mesh, b):
    bax = batch_axes(mesh)
    if bax and b % dp_size(mesh) == 0:
        return bax
    if "data" in _axes(mesh) and b % mesh_axis_size(mesh, "data") == 0:
        return ("data",)
    return None


def _layer_cache_specs(cache_shape, spec):
    """One spec per leaf of the port's per-layer caches (a list of dicts),
    spec(name, shape) deciding."""
    return [{k: spec(k, _shape(v)) for k, v in layer.items()}
            for layer in cache_shape]


def cache_specs(cfg, cache_shape, mesh):
    """Decode caches (the port's list of per-layer dicts, batch dim first).
    Attention k/v: batch over ("pod","data") if divisible; cache *sequence*
    over "model" (flash-decoding style — GQA kv heads are too few to
    shard). SSM/RG-LRU states: batch only."""
    mdl = mesh_axis_size(mesh, "model")

    def spec(name, shape):
        dims = [None] * len(shape)
        dims[0] = _cache_batch_entry(mesh, shape[0])
        if name in ("k", "v", "cross_k", "cross_v", "pos", "cross_pos"):
            if shape[1] % mdl == 0 and mdl > 1:
                dims[1] = "model"
        return P(*dims)
    return _layer_cache_specs(cache_shape, spec)


def prefill_cache_specs(cfg, cache_shape, mesh):
    """Prefill-output caches: k/v keep the layout the attention matmul
    produces — batch over data, *head_dim* over model — instead of the
    decode cache's seq-over-model layout (the reference's §Perf iteration
    1: the seq layout needed a feature->seq reshard)."""
    mdl = mesh_axis_size(mesh, "model")

    def spec(name, shape):
        dims = [None] * len(shape)
        dims[0] = _cache_batch_entry(mesh, shape[0])
        if name in ("k", "v", "cross_k", "cross_v"):
            if shape[-1] % mdl == 0 and mdl > 1:
                dims[-1] = "model"
        return P(*dims)
    return _layer_cache_specs(cache_shape, spec)


# -------------------------------------------------------------- placement

def spec_leaves(tree):
    """The spec tuples of a spec tree, in the order of the tree's leaves."""
    return [s for _, s in _walk(tree)]


def leaf_paths(tree):
    """The path tuple of every leaf of `tree`, in the order of its leaves."""
    return [p for p, _ in _walk(tree)]


def distribute(mesh, tree, specs):
    """Every tensor of `tree` as a DTensor on `mesh` laid out by the spec
    tree `specs`. `tree` must be the same on every rank (a seeded init):
    each rank keeps its own slice of it, with no collective (gloo has no
    scatter of CUDA tensors)."""
    from torch.distributed.tensor import distribute_tensor
    leaves, tdef = tree_flatten(tree)
    s = spec_leaves(specs)
    if len(s) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(s)} specs")
    return tree_unflatten(
        [distribute_tensor(x, mesh, to_placements(mesh, sp),
                           src_data_rank=None)
         for x, sp in zip(leaves, s)], tdef)
