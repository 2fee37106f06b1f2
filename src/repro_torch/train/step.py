"""Train-step builders: forward, backward and update, with optional
microbatch gradient accumulation (the reference's `repro.train.step`).

Params stay plain tensors that require no gradient between steps, so
trained params serve as they are. A step differentiates with respect to
detached aliases of the leaves (`requires_grad_()` on `p.detach()`, which
shares p's storage), calls `torch.autograd.grad`, and hands the gradients
to the optimizer, which updates the params in place.

On a mesh (DTensor params and batch, `launch.distributed`) the same step
runs on local tensors: `sharding.spmd` gathers the params (or, tensor
parallel, hands each rank its shards of the leaves the "model" axis
splits: `sharding.tp`), feeds each rank its rows, and returns gradients
laid out as the params are and metrics averaged over the batch shards.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.models import transformer as T
from repro_torch.sharding import rules as R
from repro_torch.sharding import spmd
from repro_torch.train.losses import lm_loss

METRIC_KEYS = ("xent", "loss", "load_balance", "router_z", "dropped_frac")


def value_and_grad(loss_fn: Callable, params, *args, tp=None):
    """(loss, aux, grads) of `loss_fn(params, *args) -> (loss, aux)`: aux
    detached, grads a list in the order of the params' leaves (zeros for a
    leaf the loss does not reach, as jax.grad gives). With DTensor leaves
    (`sharding.spmd`) the loss and aux are the global means and each
    gradient a DTensor laid out as its param. With a tensor-parallel
    context (`sharding.tp`, the DTensor case only) the leaves the model
    axis splits reach `loss_fn` as their local shards
    (`spmd.split_params`), and `loss_fn` computes with `tp`."""
    leaves, spec = tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    mesh, grad_pl = spmd.batch_placements(args)
    if mesh is None and spmd.any_dtensor(leaves):
        mesh, grad_pl = leaves[0].device_mesh, None
    if mesh is None and tp is not None:
        raise ValueError("a tensor-parallel step needs DTensor params")
    with torch.enable_grad():
        if mesh is None:
            loss, aux = loss_fn(tree_unflatten(live, spec), *args)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        else:
            if grad_pl is None:    # batch replicated: no batch shards
                from torch.distributed.tensor import Replicate
                grad_pl = (Replicate(),) * mesh.ndim
            full = (spmd.gather_params(live, grad_pl) if tp is None else
                    spmd.split_params(live, R.leaf_paths(params), grad_pl,
                                      tp))
            local_args = tree_map(spmd.local, args)
            loss, aux = loss_fn(tree_unflatten(full, spec), *local_args)
            grads = torch.autograd.grad(
                loss / spmd.n_shards(mesh, grad_pl), live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    aux = {k: v.detach() for k, v in aux.items()}
    loss = loss.detach()
    if mesh is not None:
        grads = spmd.match_placements(grads, leaves)
        red = spmd.reduce_mean({"_loss": loss, **aux}, mesh, grad_pl)
        loss = red.pop("_loss")
        aux = {k: red[k] for k in aux}
    return loss, aux, grads


def build_lm_train_step(cfg, opt_update: Callable, *, microbatches: int = 1,
                        window=None, forward_fn=None, tp=None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    ``batch`` leaves are tensors on the params' device with a leading
    (per-process) batch dim; with microbatches = k the batch is split along
    it into k slices of b/k rows, the gradients are summed in float32 and
    divided by k, and the metrics are the slices' means: the activation-
    memory lever, as in the reference. ``tp`` (`sharding.tp`, on DTensor
    params) runs the model tensor-parallel over the mesh's "model" axis.
    On a mesh whose batch is split, the forward gets the batch dims'
    groups (`spmd.batch_groups`) as an argument, so the MoE load balance
    is the global (micro)batch's, in a layer recomputed in the backward
    too.
    """
    fwd = forward_fn or T.forward_train

    def loss_fn(params, mb, groups):
        return lm_loss(params, cfg, mb, fwd, window=window, tp=tp,
                       batch_groups=groups)

    def grads_of(params, mb):
        return value_and_grad(functools.partial(
            loss_fn, groups=spmd.batch_groups(mb)), params, mb, tp=tp)

    def step(params, opt_state, batch):
        _, spec = tree_flatten(params)
        if microbatches == 1:
            _, metrics, grads = grads_of(params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            rows = b // microbatches
            grads, metrics = None, {k: 0.0 for k in METRIC_KEYS}
            for i in range(microbatches):
                mb = spmd.batch_rows(batch, i * rows, (i + 1) * rows)
                _, m, g = grads_of(params, mb)
                if grads is None:
                    grads = [x.to(torch.float32, copy=True) for x in g]
                else:
                    torch._foreach_add_([spmd.local(x) for x in grads],
                                        [spmd.local(x) for x in g])
                metrics = {k: metrics[k] + m[k] for k in METRIC_KEYS}
            torch._foreach_div_([spmd.local(x) for x in grads],
                                float(microbatches))
            metrics = {k: v / microbatches for k, v in metrics.items()}
        params, opt_state, opt_metrics = opt_update(
            tree_unflatten(grads, spec), opt_state, params)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return step


def build_dnn_train_step(cfg, opt_update: Callable, loss_fn: Callable):
    """Train step for the paper's tabular MLPs (core sweep workload).
    `loss_fn(params, cfg, batch, key) -> (loss, aux)`; key is a
    torch.Generator for dropout, or None."""
    def step(params, opt_state, batch, key=None):
        _, spec = tree_flatten(params)
        loss, aux, grads = value_and_grad(loss_fn, params, cfg, batch, key)
        params, opt_state, om = opt_update(tree_unflatten(grads, spec),
                                           opt_state, params)
        return params, opt_state, {"loss": loss, **aux, **om}

    return step
