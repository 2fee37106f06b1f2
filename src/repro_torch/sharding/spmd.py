"""How a step runs on DTensor leaves: the port's counterpart of jit with
in/out shardings.

Params and optimizer state live as DTensors laid out by the rule engine
(`rules.param_specs`), the batch as a DTensor sharded over the batch axes
(`rules.batch_specs`). A step computes on local tensors with the same code
as on one device:

- each parameter is all-gathered to a full local tensor (`redistribute` to
  Replicate, then `to_local`) whose gradient is declared Partial(sum) over
  the mesh dims the batch is sharded on and Replicate elsewhere, so the
  backward all-reduces it over those dims and slices it back to the
  parameter's own placements (ZeRO-3 style over "model": the model axis
  shards storage, and every rank of it runs the same rows), except under
  tensor parallelism (`sharding.tp`, the train step, `split_params`):
  there a leaf the "model" axis splits is used as its local shard, whose
  gradient is already the shard's, each rank of the axis computes only
  its heads, FFN columns or experts, RG-LRU channels or Mamba2 heads and
  vocabulary rows, and the model's explicit all-reduces carry the
  residual stream across the split;
- each rank runs the model on its own rows of the batch (`to_local`);
- the loss a rank differentiates is its mean over its rows divided by the
  number of batch shards, so the summed gradient is the global mean's;
- a statistic the loss takes over the whole batch before it multiplies
  (the MoE load-balance loss: the product of two batch means) is made
  global inside the step (`global_batch_mean` over the `batch_groups`
  the step hands the forward as an argument), so each rank's loss
  carries the global product, as the reference's one program over the
  global batch does;
- elementwise optimizer updates run on the local shards in place
  (`local`), and the global norm sums each leaf's squares over the dims it
  is sharded on.

A serving step (prefill, decode) of every family runs tensor parallel
too (`call_split`): each split parameter as its local shard, the batch
as the rank's rows, each decode cache as the rank's rows and slice of
the sequence (`rules.cache_specs`; a recurrent state as the rank's rows,
whole), the outputs laid out by the rules (the prefill caches moved from
the rank's kv heads to head_dim over "model").

Without DTensors none of this runs: the one-device arithmetic is unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from repro_torch.sharding import rules as R


def is_dtensor(x) -> bool:
    # a DTensor is a Tensor subclass: plain tensors never import the module
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def any_dtensor(tree) -> bool:
    return any(is_dtensor(x) for x in tree_leaves(tree))


def local(x):
    """The local shard of a DTensor (it shares the DTensor's storage, so an
    in-place update of it updates the DTensor); any other value as is."""
    return x.to_local() if is_dtensor(x) else x


def batch_placements(tree):
    """(mesh, placements of a gradient summed over the batch shards):
    Partial() on every mesh dim that shards some DTensor leaf of `tree`
    (the batch), Replicate() elsewhere; (None, None) without DTensors."""
    dts = [x for x in tree_leaves(tree) if is_dtensor(x)]
    if not dts:
        return None, None
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = dts[0].device_mesh
    sharded = [any(isinstance(x.placements[i], Shard) for x in dts)
               for i in range(mesh.ndim)]
    return mesh, tuple(Partial() if s else Replicate() for s in sharded)


def n_shards(mesh, placements) -> int:
    """How many batch shards the Partial dims of `placements` hold."""
    from torch.distributed.tensor import Partial
    n = 1
    for i, p in enumerate(placements):
        if isinstance(p, Partial):
            n *= mesh.size(i)
    return n


def batch_groups(batch) -> tuple:
    """The process groups of the mesh dims (of size > 1) that split the
    rows of `batch` (a tree with DTensor leaves: `batch_placements`); ()
    for plain tensors or a replicated batch."""
    mesh, placements = batch_placements(batch)
    if mesh is None:
        return ()
    from torch.distributed.tensor import Partial
    return tuple(mesh.get_group(i) for i, p in enumerate(placements)
                 if isinstance(p, Partial) and mesh.size(i) > 1)


def global_batch_mean(x, groups: tuple = ()):
    """`x`, a mean over this rank's rows of the batch, as the mean over
    the global batch: summed over the batch shards of `groups`
    (`batch_groups`) and divided by their number (the shards hold equal
    rows, so this is exact). The sum is an all-reduce whose backward is
    the same all-reduce, so every rank's gradient of a loss that reads the
    result carries every rank's share (after the step's sum of the ranks'
    gradients: the global batch's gradient). Without groups, `x` itself.
    The groups are an argument, not ambient state: a layer recomputed in
    the backward (remat) runs on autograd's own thread on a card."""
    if not groups:
        return x
    n = 1
    for g in groups:
        n *= g.size()
    return _SumOverBatch.apply(x, groups) / n


def _all_reduce_over(x, groups):
    import torch.distributed._functional_collectives as funcol
    for g in groups:
        x = funcol.wait_tensor(funcol.all_reduce(x.contiguous(), "sum", g))
    return x


class _SumOverBatch(torch.autograd.Function):
    # torch.distributed.nn.functional.all_reduce has this backward too, but
    # is deprecated for the functional collectives, which have none
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _all_reduce_over(x, groups)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_over(g, ctx.groups), None


def gather_params(leaves: List, grad_placements) -> List:
    """Each DTensor leaf as a full local tensor (differentiable: its
    gradient is read as `grad_placements` and brought back to the leaf's
    placements in the backward); other leaves as they are."""
    from torch.distributed.tensor import Replicate
    out = []
    for p in leaves:
        if is_dtensor(p):
            full = p.redistribute(p.device_mesh,
                                  [Replicate()] * p.device_mesh.ndim)
            p = full.to_local(grad_placements=grad_placements)
        out.append(p)
    return out


def split_params(leaves: List, paths: List, grad_placements, tp) -> List:
    """The tensor-parallel counterpart of `gather_params`: each DTensor
    leaf as the local tensor the rank computes with, by `tp.role` of its
    path. A split leaf is its local shard, its gradient already the
    shard's (Shard over "model"); any other leaf is gathered, its gradient
    Partial over "model" where it is used inside the head split and
    Replicate where every rank uses it whole. A leaf stored split over
    "model" is gathered by `tp.gather_from_model` (all-reduces, as every
    collective of the split: gloo runs no other on CUDA tensors), whose
    backward reduces a partial gradient and hands the rank its shard's.
    Over the batch axes every gradient is read as `grad_placements`
    gives."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.sharding.tp import gather_from_model
    out = []
    for p, path in zip(leaves, paths):
        if not is_dtensor(p):
            out.append(p)
            continue
        mesh = p.device_mesh
        m = mesh.mesh_dim_names.index("model")
        role = tp.role(path)
        pl = list(grad_placements)
        stored = p.placements[m]
        if role[0] == "shard":
            if stored != Shard(role[1]):
                raise ValueError(f"{'/'.join(map(str, path))} is stored as "
                                 f"{stored} over 'model', computed as "
                                 f"Shard({role[1]})")
            pl[m] = Shard(role[1])
        elif isinstance(stored, Shard):
            pl[m] = stored
            out.append(gather_from_model(p.to_local(grad_placements=pl), tp,
                                         stored.dim, role[0] == "partial"))
            continue
        else:
            p = p.redistribute(mesh, [Replicate()] * mesh.ndim)
            pl[m] = Partial() if role[0] == "partial" else Replicate()
        out.append(p.to_local(grad_placements=pl))
    return out


def reduce_mean(values: Dict[str, torch.Tensor], mesh, placements):
    """Each scalar's mean over the batch shards (one all-reduce): the
    global value of a per-rank mean over equal row counts."""
    from torch.distributed.tensor import DTensor
    keys = list(values)
    vec = torch.stack([values[k].float().reshape(()) for k in keys])
    vec = vec / n_shards(mesh, placements)
    full = DTensor.from_local(vec, mesh, placements).full_tensor()
    return {k: full[i] for i, k in enumerate(keys)}


def leaf_norms(leaves: List) -> List[torch.Tensor]:
    """The float64 2-norm of every leaf (of a DTensor: over all of its
    shards, the squares of each group of leaves sharded alike summed in one
    all-reduce)."""
    norms = [torch.linalg.vector_norm(local(x), dtype=torch.float64)
             for x in leaves]
    if not any(is_dtensor(x) for x in leaves):
        return norms
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    groups: Dict = {}
    for i, x in enumerate(leaves):
        if is_dtensor(x) and any(isinstance(p, Shard) for p in x.placements):
            key = (id(x.device_mesh), tuple(isinstance(p, Shard)
                                            for p in x.placements))
            groups.setdefault(key, (x.device_mesh, []))[1].append(i)
    for (_, shard_dims), (mesh, idx) in groups.items():
        sq = torch.stack([norms[i] ** 2 for i in idx])
        pl = [Partial() if s else Replicate() for s in shard_dims]
        total = DTensor.from_local(sq, mesh, pl).full_tensor()
        for j, i in enumerate(idx):
            norms[i] = torch.sqrt(total[j])
    return norms


def match_placements(grads: List, params: List) -> List:
    """Each DTensor gradient redistributed to its parameter's placements
    (a Partial gradient is reduced)."""
    out = []
    for g, p in zip(grads, params):
        if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        out.append(g)
    return out


def batch_rows(batch: Dict, lo: int, hi: int) -> Dict:
    """Rows [lo, hi) of the global batch (a microbatch): plain tensors are
    sliced; a DTensor leaf is gathered, sliced and laid out again by the
    batch rule for its new row count (`rules.batch_specs`)."""
    from torch.distributed.tensor import distribute_tensor
    out = {}
    for k, v in batch.items():
        if is_dtensor(v):
            mesh = v.device_mesh
            rows = v.full_tensor()[lo:hi]
            spec = R.batch_specs(None, {k: rows}, mesh)[k]
            v = distribute_tensor(rows, mesh, R.to_placements(mesh, spec),
                                  src_data_rank=None)
        else:
            v = v[lo:hi]
        out[k] = v
    return out


def host_scalars():
    """A context for the optimizer's host-side scalars (the step counter,
    the schedule, the bias corrections): they stay real CPU values even
    inside a fake tensor mode (the dry-run), where reading one back with
    float() would otherwise fail."""
    try:
        from torch._subclasses.fake_tensor import unset_fake_temporarily
    except ImportError:     # no fake tensors in this build
        return contextlib.nullcontext()
    return unset_fake_temporarily()


def row_offset(x) -> int:
    """The index in the global batch of this rank's first row of DTensor
    `x` (dim 0 sharded over the mesh dims whose placement is Shard(0),
    major first)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    off, size = 0, x.shape[0]
    for i, p in enumerate(x.placements):
        if p == Shard(0):
            size //= mesh.size(i)
            off += coord[i] * size
    return off


def serve_params(leaves: List, paths: List, tp) -> List:
    """The serving counterpart of `split_params`: each DTensor parameter
    as the local tensor the rank computes with, by `tp.role` of its path
    (no gradients): a split leaf its local shard; a leaf stored split over
    "model" but taken whole gathered by `tp.gather_from_model` (one
    all-reduce); a replicated leaf as it is. Parameters are laid out over
    "model" only (`rules.param_specs`)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.tp import gather_from_model
    out = []
    for p, path in zip(leaves, paths):
        if not is_dtensor(p):
            out.append(p)
            continue
        m = p.device_mesh.mesh_dim_names.index("model")
        if any(not isinstance(pl, Replicate)
               for i, pl in enumerate(p.placements) if i != m):
            raise ValueError(f"{'/'.join(map(str, path))} is split over "
                             f"another axis than 'model': {p.placements}")
        role, stored = tp.role(path), p.placements[m]
        if role[0] == "shard":
            if stored != Shard(role[1]):
                raise ValueError(f"{'/'.join(map(str, path))} is stored as "
                                 f"{stored} over 'model', computed as "
                                 f"Shard({role[1]})")
            out.append(p.to_local())
        elif isinstance(stored, Shard):
            out.append(gather_from_model(p.to_local(), tp, stored.dim,
                                         False))
        else:
            out.append(p.to_local())
    return out


def call_split(fn, args, out_specs, tp, local_specs=None):
    """Run `fn` (a serving step built with `tp`: `serve.step.build_prefill`
    / `build_decode`) tensor parallel over "model" on each rank. `args[0]`
    is the params (DTensors laid out by `rules.param_specs`), handed over
    by `serve_params`: each split leaf as its local shard. Every other
    DTensor argument is handed over as the rank's local tensor, as it is
    laid out: the batch as the rank's rows, a decode cache as its rows and
    slice of the sequence (`rules.cache_specs`), written in place. Each
    output is laid out by `out_specs` from its layout on the rank,
    `local_specs` (default: `out_specs`), which may differ over "model"
    only: a dim held whole is sliced; a dim split over "model" is
    gathered where `out_specs` holds it whole, and moved where it names
    another dim (the prefill caches' kv heads to head_dim,
    `tp.heads_to_head_dim`: an all-to-all where the model group runs one
    on the tensors' device, else an all-reduce). Plain arguments pass as
    they are."""
    from torch.distributed.tensor import DTensor
    mesh = tp.mesh
    p_leaves, p_def = tree_flatten(args[0])
    params = tree_unflatten(serve_params(p_leaves, R.leaf_paths(args[0]),
                                         tp), p_def)
    rest, r_def = tree_flatten(args[1:])
    out = fn(params, *tree_unflatten([local(x) for x in rest], r_def))
    o_leaves, o_def = tree_flatten(out)
    specs = R.spec_leaves(out_specs)
    have = specs if local_specs is None else R.spec_leaves(local_specs)
    if not len(specs) == len(have) == len(o_leaves):
        raise ValueError(f"{len(o_leaves)} outputs, {len(specs)} specs, "
                         f"{len(have)} local specs")
    placed = []
    for o, spec, was in zip(o_leaves, specs, have):
        o = _relayout(o, was, spec, tp)
        placed.append(DTensor.from_local(o, mesh,
                                         R.to_placements(mesh, spec)))
    return tree_unflatten(placed, o_def)


def _model_dim(spec):
    for d, e in enumerate(spec):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return d
    return None


def _relayout(o, was, spec, tp):
    """Local output `o`, laid out by `was`, as `spec` lays it out (they
    differ over "model" only)."""
    from repro_torch.sharding import tp as TP
    a, b = _model_dim(was), _model_dim(spec)
    if a == b:
        return o
    if a is None:
        return tp.shard(o, b).contiguous()
    if b is None:
        return TP.gather_from_model(o, tp, a, False)
    if (a, b) != (2, 3):
        raise ValueError(f"no move of a dim over 'model' from {was} to "
                         f"{spec}")
    return TP.heads_to_head_dim(o, tp, tp.runs_all_to_all(o))
