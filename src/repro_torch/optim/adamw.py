"""AdamW with decoupled weight decay and global-norm clipping, the
reference's `repro.optim.adamw` over the port's parameter trees (nested
dicts, lists and tuples of tensors). The (init, update) pair keeps the
trainer optimizer-agnostic.

Moments are float32 whatever the parameter dtype. `update` works in place
under `torch.no_grad()`: the moments and the parameters are overwritten
(the torch counterpart of the reference's donated buffers), and the new
state and the same parameter tree are returned. The step counter is a 0-d
int32 tensor on the CPU, so the schedule and the bias corrections cost the
card no sync; the gradient norm stays on the parameters' device.

On DTensor leaves (`sharding.spmd`) the moments take each param's layout,
the gradients are brought to it, the global norm sums every leaf over its
shards, and the elementwise update runs on the local shards in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

from repro_torch.sharding import spmd

CHUNK_ELEMENTS = 1 << 27   # leaves updated together: bounds the temporaries


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: dict
    nu: dict


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, as a float32 scalar. Each
    leaf's sum is accumulated in float64: torch's float32 norm of a leaf of
    millions of elements drifts on the CPU (1e-2 relative at 2^22 equal
    elements; 2e-4 for a full-width qwen3-1.7b gradient), where the card's
    agrees with a float64 norm within 1e-7."""
    norms = spmd.leaf_norms(tree_leaves(tree))
    return torch.linalg.vector_norm(torch.stack(norms)).to(torch.float32)


def clip_by_global_norm(tree, max_norm):
    """(tree scaled by min(1, max_norm / (norm + 1e-9)) in float32, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, tree), norm


def aligned_leaves(params, *trees):
    """The leaves of params and of each tree of its shape (gradients,
    moments), in one order. Raises ValueError where a tree's structure,
    dict key order included, differs from the params': zipping leaves in
    another order would update one leaf with another's moments."""
    leaves, spec = tree_flatten(params)
    out = [leaves]
    for t in trees:
        t_leaves, t_spec = tree_flatten(t)
        if t_spec != spec:
            raise ValueError("gradient or optimizer-state tree does not "
                             "match the params' structure")
        out.append(t_leaves)
    return out


def _chunks(*lists):
    """Consecutive groups of the zipped leaves, about CHUNK_ELEMENTS each."""
    group, size = [], 0
    for item in zip(*lists):
        group.append(item)
        size += item[0].numel()
        if size >= CHUNK_ELEMENTS:
            yield [list(c) for c in zip(*group)]
            group, size = [], 0
    if group:
        yield [list(c) for c in zip(*group)]


def _write_back(ps, p32s):
    """Store the float32 results in the parameters' own dtype."""
    for p, p32 in zip(ps, p32s):
        if p32 is not p:
            p.copy_(p32)


def _bias_correction(beta: float, step: torch.Tensor) -> float:
    """1 - beta ** step, in float32 as the reference computes it."""
    return float(1 - torch.tensor(beta, dtype=torch.float32)
                 ** step.to(torch.float32))


def adamw(lr: Callable | float, *, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1, clip_norm: Optional[float] = 1.0):
    lr_fn = lr if callable(lr) else (lambda _: torch.tensor(
        lr, dtype=torch.float32))

    def init(params):
        def zeros(p):    # a DTensor param gives a DTensor of its layout
            return torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state, params):
        with spmd.host_scalars():
            step = state.step + 1
            bc1, bc2 = _bias_correction(b1, step), _bias_correction(b2, step)
            lr_t = lr_fn(step)
            lr_f = float(lr_t)
        leaves = aligned_leaves(params, grads, state.mu, state.nu)
        leaves[1] = spmd.match_placements(leaves[1], leaves[0])
        gnorm = global_norm(leaves[1])
        scale = (torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
                 if clip_norm is not None else None)
        leaves = [[spmd.local(x) for x in ls] for ls in leaves]
        for ps, g, m, v in _chunks(*leaves):
            g = [x.float() for x in g]
            if scale is not None:
                g = torch._foreach_mul(g, scale)
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, g, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, g, g, value=1 - b2)
            del g
            denom = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            u = torch._foreach_div(m, bc1)
            torch._foreach_div_(u, denom)
            del denom
            p32 = [p.float() for p in ps]
            torch._foreach_add_(u, p32, alpha=weight_decay)
            torch._foreach_add_(p32, u, alpha=-lr_f)
            _write_back(ps, p32)
        return params, AdamWState(step, state.mu, state.nu), \
            {"grad_norm": gnorm, "lr": lr_t}

    return init, update
