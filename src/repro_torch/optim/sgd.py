"""SGD with optional momentum, the PyBrain-side baseline optimizer of the
paper's dual-backend comparison (the reference's `repro.optim.sgd`).
In place under `torch.no_grad()`, as `adamw`; the velocity is float32,
and on DTensor leaves it takes each param's layout, as `adamw`'s moments."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils._pytree import tree_map

from repro_torch.optim.adamw import _chunks, _write_back, aligned_leaves
from repro_torch.sharding import spmd


class SGDState(NamedTuple):
    step: torch.Tensor
    velocity: dict


def sgd(lr: Callable | float, *, momentum=0.9, nesterov=False):
    lr_fn = lr if callable(lr) else (lambda _: torch.tensor(
        lr, dtype=torch.float32))

    def init(params):
        return SGDState(step=torch.zeros((), dtype=torch.int32),
                        velocity=tree_map(
                            lambda p: torch.zeros_like(p,
                                                       dtype=torch.float32),
                            params))

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        lr_f = float(lr_t)
        ps, gs, vs = aligned_leaves(params, grads, state.velocity)
        gs = spmd.match_placements(gs, ps)
        leaves = [[spmd.local(x) for x in ls] for ls in (ps, gs, vs)]
        for ps, g, vel in _chunks(*leaves):
            g = [x.float() for x in g]
            torch._foreach_mul_(vel, momentum)
            torch._foreach_add_(vel, g)
            if nesterov:
                upd = torch._foreach_add(g, vel, alpha=momentum)
            else:
                upd = vel
            p32 = [p.float() for p in ps]
            torch._foreach_add_(p32, upd, alpha=-lr_f)
            _write_back(ps, p32)
        return params, SGDState(step, state.velocity), {"lr": lr_t}

    return init, update
