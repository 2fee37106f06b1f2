"""Population plane: ensemble training of shape-homogeneous tasks as stacked
members (the reference's `repro.core.population`, which vmaps).

K tasks that share one shape signature are stacked on a leading population
axis: every leaf carries K first (`w` (K, d_in, d_out), `b` (K, d_out)),
member i drawn as `dnn_train` draws its payload (`member_params`), then
stacked. A step runs one `torch.baddbmm` per layer for all K members, the
batch (B, F) broadcast to (K, B, F); each member's loss is its own mean
cross-entropy (the reference's `dnn_loss`), and one backward of their sum
gives each member its own gradient, since members share no parameter. The
optimizer (`optim.stacked`) clips each member by its own norm and steps it
with its own learning rate, as the reference's AdamW/SGD under `jax.vmap`.

Fail-forward happens *in-graph*: a member whose loss is non-finite at a
step is frozen from that step on — its params and its whole optimizer
state, step count included, keep their values (`torch.where` on the card),
and it is reported failed. `alive` and `losses` stay on the device until
the end of training: the step loop reads nothing back to the host.

On a mesh (`mesh=`, a DeviceMesh, and `population_axes=`, the reference's
arguments) the leading member axis of the lrs, the stacked params and the
optimizer state is sharded over those axes (DTensor `Shard(0)`, replicated
over the mesh's other axes): each rank steps its own K / n members on its
local shards, the batches are the same on every rank, and nothing is
communicated until the results are gathered at the end. The reference
shards `lrs` and lets GSPMD propagate that to the members. K must divide
by the axes' size (the reference would fail to shard). The params tree
`population_params` returned is updated in place with the trained members,
as without a mesh.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                  tree_unflatten)

from repro_torch.configs.base import MLPConfig
from repro_torch.core.executors import (DeviceData, _get_dataset,
                                        member_params, sync)
from repro_torch.core.results import ResultStore
from repro_torch.core.tasks import TaskSpec
from repro_torch.core.worker import context_device
from repro_torch.models.layers import ACTIVATIONS
from repro_torch.optim.stacked import stacked_adamw, stacked_sgd
from repro_torch.sharding import rules as R
from repro_torch.train.step import value_and_grad


def _block_config(block: List[TaskSpec], ds) -> MLPConfig:
    p0 = block[0].payload
    return MLPConfig(n_features=ds.n_features, n_classes=ds.n_classes,
                     hidden_sizes=tuple(p0["hidden_sizes"]),
                     activations=tuple(p0.get("activations", ("relu",))),
                     dropout=float(p0.get("dropout", 0.0)))


def population_params(seeds: List[int], cfg: MLPConfig, device):
    """The block's members, each drawn as `dnn_train` draws its task,
    stacked on a leading K axis."""
    members = [member_params(s, cfg, device) for s in seeds]
    return tree_map(lambda *xs: torch.stack(xs), *members)


def forward_population(params, cfg: MLPConfig, x):
    """x: (B, n_features), shared by every member -> logits (K, B,
    n_classes): `forward_dnn` for each member (no dropout: the reference's
    population trains without it)."""
    layers = params["layers"]
    h = x.expand(layers[0]["w"].shape[0], *x.shape)
    for i, lp in enumerate(layers):
        h = torch.baddbmm(lp["b"].unsqueeze(1), h, lp["w"])
        if i < len(layers) - 1:
            h = ACTIVATIONS[cfg.activations[i % len(cfg.activations)]](h)
    return h


def population_loss(params, cfg: MLPConfig, batch):
    """(sum of the members' losses, {"losses": each member's mean softmax
    cross-entropy, (K,)}): `dnn_loss` per member."""
    logp = F.log_softmax(forward_population(params, cfg, batch["x"]).float(),
                         dim=-1)
    losses = -torch.mean(torch.sum(batch["y"] * logp, dim=-1), dim=-1)
    return losses.sum(), {"losses": losses}


def build_population_step(cfg: MLPConfig, opt_update):
    """step(params, opt_state, alive, batch) -> (params, opt_state, alive,
    losses): one step of every member; a member stays alive while its loss
    is finite, and one that is not alive keeps its params and state."""
    def step(params, opt_state, alive, batch):
        _, aux, grads = value_and_grad(population_loss, params, cfg, batch)
        losses = aux["losses"]
        ok = torch.isfinite(losses) & alive
        params, opt_state, _ = opt_update(
            tree_unflatten(grads, tree_flatten(params)[1]), opt_state,
            params, ok)
        return params, opt_state, ok, losses

    return step


def population_optimizer(opt_name: str, lrs: torch.Tensor):
    """The reference's choice: AdamW (weight_decay=0.0, the default
    clip_norm=1.0) for "adam", SGD with momentum 0.9 otherwise."""
    if opt_name == "adam":
        return stacked_adamw(lrs, weight_decay=0.0)
    return stacked_sgd(lrs, momentum=0.9)


class _MemberShards:
    """The member axis sharded over `axes` of `mesh`: each rank's local
    slice of a stacked tensor, and the gather back to all K."""

    def __init__(self, mesh, axes, K: int):
        axes = tuple(axes)
        n = 1
        for a in axes:
            n *= R.mesh_axis_size(mesh, a)
        if K % n:
            raise ValueError(f"population of {K} members does not divide "
                             f"over population_axes {axes} of size {n}")
        self.mesh = mesh
        self.placements = R.to_placements(mesh, (axes,))

    def local(self, x: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(x, self.mesh, self.placements,
                                 src_data_rank=None).to_local()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import DTensor
        y = x.to(torch.uint8) if x.dtype == torch.bool else x  # gloo: no bool
        y = DTensor.from_local(y, self.mesh, self.placements).full_tensor()
        return y.to(x.dtype)


def train_population(block: List[TaskSpec], context: Dict[str, Any], *,
                     results: Optional[ResultStore] = None,
                     mesh=None, population_axes=("data",)) -> List[dict]:
    """Train every task in `block` simultaneously. Returns result docs (and
    inserts them into `results` if given)."""
    ds = _get_dataset(block[0].payload, context)
    cfg = _block_config(block, ds)
    device = context_device(context)
    K = len(block)
    p0 = block[0].payload
    epochs = int(p0.get("epochs", 3))
    bs = int(p0.get("batch_size", 128))
    lrs = torch.tensor([float(t.payload.get("lr", 1e-3)) for t in block],
                       dtype=torch.float32, device=device)
    seeds = [int(t.payload.get("seed", i)) for i, t in enumerate(block)]

    params = population_params(seeds, cfg, device)
    full_params = params
    shards = None if mesh is None else _MemberShards(mesh, population_axes,
                                                     K)
    if shards is not None:
        params = tree_map(shards.local, params)
        lrs = shards.local(lrs)
    opt_init, opt_update = population_optimizer(
        p0.get("optimizer", "adam"), lrs)
    opt_state = opt_init(params)
    pop_step = build_population_step(cfg, opt_update)

    k_here = lrs.shape[0]
    alive = torch.ones((k_here,), dtype=torch.bool, device=device)
    losses = torch.zeros((k_here,), dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    data = DeviceData(ds, bs, epochs, device)
    for ep in range(epochs):
        for batch in data.batches(ep):
            params, opt_state, alive, losses = pop_step(params, opt_state,
                                                        alive, batch)
    sync(device)
    wall = time.perf_counter() - t0

    # --- stacked evaluation ---
    with torch.no_grad():
        logits = forward_population(params, cfg, data.x_test)
    acc = torch.mean((logits.argmax(-1)
                      == data.y_test.argmax(-1)[None]).float(), dim=-1)
    if shards is not None:
        acc, alive, losses = (shards.gather(t) for t in (acc, alive, losses))
        with torch.no_grad():
            for dst, src in zip(tree_leaves(full_params),
                                tree_leaves(params)):
                dst.copy_(shards.gather(src))
    acc, alive, losses = (t.cpu().tolist() for t in (acc, alive, losses))

    docs = []
    n_params = int(sum(x[0].numel() for x in tree_leaves(params)))
    for i, t in enumerate(block):
        ok = alive[i] and math.isfinite(losses[i])
        doc = dict(task_id=t.task_id, session_id=t.session_id,
                   status="ok" if ok else "failed",
                   train_time=wall / K,  # amortized
                   metrics={"accuracy": acc[i],
                            "final_loss": losses[i],
                            "n_params": n_params,
                            "n_hidden_layers": len(cfg.hidden_sizes),
                            "population_size": K, "wall_time_block": wall},
                   params=t.payload,
                   error=None if ok else "diverged (frozen in-graph)")
        if results is not None:
            results.insert(**doc)
        docs.append(doc)
    return docs
