"""Host training loop: stream -> step -> metrics -> periodic checkpoint
(the reference's `repro.train.trainer`).

Checkpoints hold {"params", "opt_state"}. Given the LM's config, the loop
writes them in the reference's layout (`params.jax_layout`: blocks stacked
on a leading axis), so either package restores the other's;
`restore_train_state` reads them back into the port's layout.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch import params as P
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint


@dataclass
class TrainLog:
    steps: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    times: list = field(default_factory=list)
    extra: list = field(default_factory=list)

    def record(self, step, metrics, dt):
        self.steps.append(step)
        self.losses.append(float(metrics.get("loss", np.nan)))
        self.times.append(dt)
        self.extra.append({k: float(v) for k, v in metrics.items()
                           if np.ndim(v) == 0})


def checkpoint_tree(params, opt_state, cfg=None) -> dict:
    """{"params", "opt_state"} as the loop writes them: with an LM's `cfg`,
    params and every param-shaped field of the optimizer state (AdamW's mu
    and nu, SGD's velocity) in the reference's layout; without one (the
    MLP, whose tree is the same in both packages) as they are."""
    if cfg is None:
        return {"params": params, "opt_state": opt_state}
    return {"params": P.jax_layout(params, cfg),
            "opt_state": type(opt_state)(*(
                P.jax_layout(f, cfg) if isinstance(f, dict) else f
                for f in opt_state))}


def restore_train_state(ckpt_dir: str, step: int, params, opt_state,
                        cfg=None, device=None):
    """(params, opt_state) from a checkpoint written by `train_loop` or by
    the reference's, into the structure of the given ones (values ignored),
    each leaf in its stored dtype, on `device`; by default each leaf on
    the device of its template leaf (params on the card restore onto the
    card; AdamW's step counter stays on the CPU where `adamw` keeps it)."""
    tree = restore_checkpoint(ckpt_dir, step,
                              checkpoint_tree(params, opt_state, cfg),
                              device=device)
    if cfg is None:
        return tree["params"], tree["opt_state"]
    st = tree["opt_state"]
    return P.port_layout(tree["params"], cfg), type(st)(*(
        P.port_layout(f, cfg) if isinstance(f, dict) else f for f in st))


def train_loop(step_fn: Callable, params, opt_state, data: Iterable, *,
               num_steps: int, log_every: int = 10,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
               donate: bool = True, verbose: bool = True,
               cfg=None) -> tuple:
    """Generic loop over `step_fn(params, opt_state, batch)`. `donate` is
    accepted for the reference's signature and does nothing: the port's
    steps update params and optimizer state in place anyway. Reading the
    loss as a float at a log step waits for the card, as the reference's
    `block_until_ready` does. `cfg` (the LM's config) makes checkpoints
    follow the reference's layout (`checkpoint_tree`)."""
    del donate
    log = TrainLog()
    it = iter(data)
    t_prev = time.perf_counter()
    for s in range(1, num_steps + 1):
        batch = next(it)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if s % log_every == 0 or s == num_steps:
            loss = float(metrics["loss"])
            now = time.perf_counter()
            log.record(s, metrics, now - t_prev)
            t_prev = now
            if verbose:
                print(f"  step {s:5d}  loss {loss:.4f}  "
                      f"({log.times[-1]:.2f}s)")
        if ckpt_dir and ckpt_every and s % ckpt_every == 0:
            save_checkpoint(ckpt_dir, s,
                            checkpoint_tree(params, opt_state, cfg))
    if ckpt_dir:
        save_checkpoint(ckpt_dir, num_steps,
                        checkpoint_tree(params, opt_state, cfg))
    return params, opt_state, log
