"""Distributed (mesh-sharded) training driver (the reference's
`repro.launch.distributed`): params and optimizer state laid out on a
DeviceMesh by the rule engine's specs, per-process batch feeding, and the
train step on DTensor leaves (`sharding.spmd`): data parallel over "pod" x
"data", and over "model" tensor parallel for every family (the dense and
MoE decoders, the encoder-decoder, the RG-LRU hybrid and Mamba2:
`sharding.tp`) when the axis is larger than 1.

Every process calls ``initialize(coordinator, num_processes, process_id)``
(NCCL on the card; ``device="cpu"`` gives gloo), builds a mesh
(`launch.mesh`) and runs ``train_sharded``. On the CPU the same path runs
on gloo ranks, e.g. ``torchrun --nproc_per_node 8`` (coordinator
``env://``) or `torch.multiprocessing`, with ``device_type="cpu"``
meshes.
"""
from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.sharding import rules as R
from repro_torch.sharding.tp import TensorParallel
from repro_torch.train.step import build_lm_train_step


def initialize(coordinator: Optional[str] = None, num_processes: int = 1,
               process_id: int = 0, *, device: str = "cuda"):
    """Join the process group: NCCL on the card (each process on card
    `process_id % device_count`), gloo with ``device="cpu"``. The
    coordinator is a ``tcp://host:port`` or ``file://`` URL (a bare
    ``host:port`` means tcp), or ``env://`` under torchrun (its agent
    hosts the store); a single process without one uses an in-memory
    store. No fallback: without a card ``device="cuda"`` raises."""
    if dist.is_initialized():
        return
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda') needs a CUDA "
                               "device; pass device='cpu' for gloo")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if coordinator is None:
        if num_processes != 1:
            raise ValueError("several processes need a coordinator")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
        return
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)


def shard_model(cfg, mesh, params, opt_state):
    """Place params + optimizer moments by the rule engine's specs (each
    moment tree mirrors the params; the step counter, a host scalar equal
    on every rank, stays as it is: the replicated spec). Every process
    holds the same full trees (the same seeded init) and keeps its own
    slices of them (`rules.distribute`)."""
    p_specs = R.param_specs(cfg, params, mesh)
    o_specs = R.opt_state_specs(cfg, opt_state, p_specs)
    params = R.distribute(mesh, params, p_specs)
    step, *moments = opt_state
    opt_state = type(opt_state)(step, *[R.distribute(mesh, m, p_specs)
                                         for m in moments])
    return params, opt_state, p_specs, o_specs


def make_sharded_step(cfg, mesh, opt_update, p_specs, o_specs, batch_example,
                      *, microbatches: int = 1):
    """(step on DTensor leaves, the batch specs of `batch_example`). The
    step is tensor parallel over "model" (`sharding.tp`) when the axis is
    larger than 1, else data parallel with the params gathered
    (`sharding.spmd`)."""
    b_specs = R.batch_specs(cfg, batch_example, mesh)
    step = build_lm_train_step(cfg, opt_update, microbatches=microbatches,
                               tp=TensorParallel.build(cfg, mesh))
    return step, b_specs


def put_batch(mesh, b_specs, batch):
    """The global batch (numpy or tensors, equal on every process) as
    DTensors on `mesh` laid out by `b_specs`; each rank keeps its rows."""
    from torch.distributed.tensor import distribute_tensor
    dev = mesh.device_type

    def put(x, spec):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        t = t.to(dev).contiguous()
        return distribute_tensor(t, mesh, R.to_placements(mesh, spec),
                                 src_data_rank=None)
    return {k: put(v, b_specs[k]) for k, v in batch.items()}


def train_sharded(cfg, mesh, data: Iterable, *, num_steps: int, lr=3e-4,
                  microbatches: int = 1, seed: int = 0, log_every: int = 10,
                  verbose: bool = True):
    """End-to-end sharded training loop. Returns (params, opt_state,
    losses); the params and moments are DTensors on `mesh`."""
    dev = torch.device(mesh.device_type)
    with R.mesh_context(mesh):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = T.init_lm(gen, cfg)
        params = tree_map(lambda p: p.to(dev), params)
        opt_init, opt_update = adamw(
            linear_warmup_cosine(lr, max(num_steps // 10, 1), num_steps))
        opt_state = opt_init(params)
        params, opt_state, p_specs, o_specs = shard_model(cfg, mesh, params,
                                                          opt_state)
        it = iter(data)
        first = next(it)
        step, b_specs = make_sharded_step(cfg, mesh, opt_update, p_specs,
                                          o_specs, first,
                                          microbatches=microbatches)
        losses = []
        t0 = time.perf_counter()
        batch = first
        for s in range(1, num_steps + 1):
            params, opt_state, m = step(params, opt_state,
                                        put_batch(mesh, b_specs, batch))
            if s % log_every == 0 or s == num_steps:
                losses.append(float(m["loss"]))
                if verbose:
                    print(f"  [sharded] step {s} loss {losses[-1]:.4f}")
            if s < num_steps:
                batch = next(it)
        if verbose:
            print(f"  [sharded] {num_steps} steps in "
                  f"{time.perf_counter() - t0:.1f}s on {mesh.size()} "
                  f"devices")
    return params, opt_state, losses
