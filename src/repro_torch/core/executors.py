"""Task executors: the training functions Celery runs on the workers (the
reference's `repro.core.executors`).

``dnn_train`` is the paper's workload (tabular MLP with swept layer design);
``lm_train`` extends the same machinery to the assigned LM architecture zoo
(reduced configs). Both train on the context's device (`context_device`:
"cuda" unless the context says "cpu"), from weights drawn by a
`torch.Generator` seeded with the payload's seed (`member_params`; the
reference draws `jax.random.PRNGKey(seed)`, whose bits differ).

Neither reads a loss back to the host inside its step loop: the data goes
to the device once and each batch is gathered there (`DeviceData`), so the
loop only queues work. ``dnn_train`` waits for the card twice, as the
reference does: at the start of epoch 1, so that `steady_epoch_time`
leaves out epoch 0's first calls, and at the end.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import MLPConfig
from repro_torch.core.worker import context_device, register_executor
from repro_torch.data import pipeline, synthetic, tokens
from repro_torch.models.dnn import dnn_loss, forward_dnn, init_dnn
from repro_torch.optim import adamw, sgd
from repro_torch.train.step import build_dnn_train_step


def _get_dataset(payload: Dict[str, Any], context: Dict[str, Any]):
    """Datasets come from the session context (the paper's uploaded CSV) or a
    synthetic descriptor embedded in the payload."""
    ref = payload.get("dataset", "default")
    data = context.get("datasets", {})
    if ref in data:
        return data[ref]
    if isinstance(ref, dict) and ref.get("synthetic"):
        csv = synthetic.classification_csv(
            ref.get("n", 2000), ref.get("features", 16),
            ref.get("classes", 4), seed=ref.get("seed", 0))
        ds = pipeline.prepare(csv, "label", seed=ref.get("seed", 0))
        context.setdefault("datasets", {})[str(ref)] = ds
        return ds
    raise KeyError(f"dataset {ref!r} not found in session context")


def sync(device: torch.device):
    """Wait for the work queued on this thread's current stream (a worker's
    own stream), not for the whole device."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class DeviceData:
    """A dataset's arrays on `device`, copied there once. `batches(epoch)`
    gives `pipeline.batches(x_train, y_train, batch_size, seed=epoch)`'s
    batches in its order, gathered on the device: no host-to-device copy
    (a blocking one waits for the card) inside a step loop."""

    def __init__(self, ds, batch_size: int, epochs: int, device):
        n = ds.x_train.shape[0]
        rows = np.arange(n)
        order = [[b["x"] for b in pipeline.batches(rows, rows, batch_size,
                                                   seed=ep)]
                 for ep in range(epochs)]
        self.index = torch.as_tensor(np.array(order, np.int64).reshape(
            epochs, -1, batch_size), device=device)
        self.x_train = torch.as_tensor(ds.x_train, device=device)
        self.y_train = torch.as_tensor(ds.y_train, device=device)
        self.x_test = torch.as_tensor(ds.x_test, device=device)
        self.y_test = torch.as_tensor(ds.y_test, device=device)

    def batches(self, epoch: int):
        for idx in self.index[epoch]:
            yield {"x": self.x_train.index_select(0, idx),
                   "y": self.y_train.index_select(0, idx)}


def member_params(seed: int, cfg: MLPConfig, device):
    """The MLP a task starts from: `init_dnn` on a generator on `device`
    seeded with the task's seed. A population member of the same payload
    starts from the same draw (`population.population_params`)."""
    return init_dnn(torch.Generator(device).manual_seed(seed), cfg)


def _mlp_config(payload: Dict[str, Any], ds) -> MLPConfig:
    return MLPConfig(
        n_features=ds.n_features, n_classes=ds.n_classes,
        hidden_sizes=tuple(payload.get("hidden_sizes", (64,))),
        activations=tuple(payload.get("activations", ("relu",))),
        dropout=float(payload.get("dropout", 0.0)))


@register_executor("dnn_train")
def dnn_train(payload: Dict[str, Any], context: Dict[str, Any]):
    ds = _get_dataset(payload, context)
    cfg = _mlp_config(payload, ds)
    if payload.get("fail"):                      # test hook for fail-forward
        raise RuntimeError("injected failure")
    device = context_device(context)
    lr = float(payload.get("lr", 1e-3))
    opt_name = payload.get("optimizer", "adam")  # the Keras/PyBrain axis
    if opt_name == "adam":
        opt_init, opt_update = adamw(lr, weight_decay=0.0)
    else:
        opt_init, opt_update = sgd(lr, momentum=0.9)
    params = member_params(int(payload.get("seed", 0)), cfg, device)
    opt_state = opt_init(params)
    step = build_dnn_train_step(cfg, opt_update, dnn_loss)
    epochs = int(payload.get("epochs", 3))
    bs = int(payload.get("batch_size", 128))
    t0 = time.perf_counter()
    data = DeviceData(ds, bs, epochs, device)
    loss = torch.zeros((), device=device)
    t_steady = None
    for ep in range(epochs):
        if ep == 1:                      # epoch 0 includes the first calls
            sync(device)
            t_steady = time.perf_counter()
        for batch in data.batches(ep):
            params, opt_state, m = step(params, opt_state, batch)
            loss = m["loss"]
    sync(device)
    train_time = time.perf_counter() - t0
    steady_epoch_time = ((time.perf_counter() - t_steady) / (epochs - 1)
                         if t_steady and epochs > 1 else train_time / epochs)
    # test-set evaluation (the paper's held-out 20%)
    with torch.no_grad():
        logits = forward_dnn(params, cfg, data.x_test)
    acc = float(torch.mean((logits.argmax(-1) == data.y_test.argmax(-1))
                           .float()))
    final_loss = float(loss)
    if not math.isfinite(final_loss):
        raise FloatingPointError("training diverged (non-finite loss)")
    return {"accuracy": acc, "final_loss": final_loss,
            "train_time": train_time,
            "steady_epoch_time": steady_epoch_time,   # first calls excluded
            "n_params": int(sum(x.numel() for x in tree_leaves(params))),
            "n_hidden_layers": len(cfg.hidden_sizes)}


@register_executor("lm_train")
def lm_train(payload: Dict[str, Any], context: Dict[str, Any]):
    """Train a reduced LM-zoo config for a few steps on synthetic tokens."""
    from repro_torch.configs import registry as cfg_registry
    from repro_torch.launch.train import stub_inputs
    from repro_torch.models import transformer as T
    from repro_torch.train.step import build_lm_train_step

    cfg = cfg_registry.get(payload["arch"], reduced=True)
    device = context_device(context)
    steps = int(payload.get("steps", 5))
    bs = int(payload.get("batch_size", 4))
    seq = int(payload.get("seq_len", 32))
    seed = int(payload.get("seed", 0))
    params = T.init_lm(torch.Generator(device).manual_seed(seed), cfg)
    opt_init, opt_update = adamw(float(payload.get("lr", 3e-4)))
    opt_state = opt_init(params)
    step = build_lm_train_step(cfg, opt_update)
    stream = tokens.TokenStream(cfg.vocab_size, seq, bs, seed=seed)
    stubs = stub_inputs(cfg, bs, seq, device)
    t0 = time.perf_counter()
    losses = []
    for i, batch in zip(range(steps), stream):
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        b.update(stubs)
        params, opt_state, m = step(params, opt_state, b)
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    return {"final_loss": losses[-1], "first_loss": losses[0],
            "train_time": time.perf_counter() - t0, "steps": steps}

