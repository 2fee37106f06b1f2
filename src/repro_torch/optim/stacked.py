"""AdamW and SGD over a population of K members stacked on a leading axis,
with each member's own arithmetic: what the reference gets by running
`repro.optim.adamw` / `sgd` under `jax.vmap` (`repro.core.population`).

Every leaf of params, gradients and state carries the K axis first.
Member k is clipped by its own global norm (summed over its own leaves in
float64, as `adamw.global_norm` sums), has its own step count and bias
corrections, and its own learning rate (`lrs`, a (K,) tensor). Running
`adamw` on the stacked tree instead would clip every member by one norm
over all K and step them with one learning rate.

`update(grads, state, params, keep)` takes a (K,) bool `keep`: members
where it is False keep their params and their whole state, step count
included — the population's in-graph freeze. The states are `adamw`'s
and `sgd`'s NamedTuples with a (K,) int32 step count on the device.
Updates are written in place under `torch.no_grad()`, as `adamw`'s are,
and read nothing back to the host.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.optim.adamw import AdamWState, aligned_leaves
from repro_torch.optim.sgd import SGDState


def _per_member(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (K,) tensor shaped to broadcast over a stacked leaf."""
    return x.view(-1, *([1] * (like.dim() - 1)))


def member_norms(leaves) -> torch.Tensor:
    """Each member's global norm over its own leaves, (K,) float32; each
    leaf's sum accumulated in float64, as `adamw.global_norm` does."""
    norms = [torch.linalg.vector_norm(g.flatten(1), dim=1,
                                      dtype=torch.float64) for g in leaves]
    return torch.linalg.vector_norm(torch.stack(norms), dim=0).to(
        torch.float32)


def _zeros(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _steps(params) -> torch.Tensor:
    first = tree_leaves(params)[0]
    return torch.zeros((first.shape[0],), dtype=torch.int32,
                       device=first.device)


def _keep(keep, new, old):
    """old overwritten by new where the member is kept."""
    old.copy_(torch.where(_per_member(keep, old), new, old))


def stacked_adamw(lrs: torch.Tensor, *, b1=0.9, b2=0.95, eps=1e-8,
                  weight_decay=0.0, clip_norm=1.0):
    """`adamw` per member; `lrs` (K,) float32 on the params' device. The
    defaults are the population's: the reference's AdamW with
    weight_decay=0.0."""
    def init(params):
        return AdamWState(step=_steps(params), mu=_zeros(params),
                          nu=_zeros(params))

    @torch.no_grad()
    def update(grads, state, params, keep):
        ps, gs, ms, vs = aligned_leaves(params, grads, state.mu, state.nu)
        step = state.step + 1
        gs = [g.float() for g in gs]
        norm = member_norms(gs)
        if clip_norm is not None:
            scale = torch.clamp(clip_norm / (norm + 1e-9), max=1.0)
            gs = [g * _per_member(scale, g) for g in gs]
        t = step.to(torch.float32)
        bc1, bc2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
        for p, g, m, v in zip(ps, gs, ms, vs):
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            u = (m_new / _per_member(bc1, m)) / (
                torch.sqrt(v_new / _per_member(bc2, v)) + eps)
            p32 = p.float()
            u = u + weight_decay * p32
            _keep(keep, (p32 - _per_member(lrs, p) * u).to(p.dtype), p)
            _keep(keep, m_new, m)
            _keep(keep, v_new, v)
        step = torch.where(keep, step, state.step)
        return params, AdamWState(step, state.mu, state.nu), \
            {"grad_norm": norm, "lr": lrs}

    return init, update


def stacked_sgd(lrs: torch.Tensor, *, momentum=0.9):
    """`sgd` (no Nesterov) per member; `lrs` (K,) float32."""
    def init(params):
        return SGDState(step=_steps(params), velocity=_zeros(params))

    @torch.no_grad()
    def update(grads, state, params, keep):
        ps, gs, vels = aligned_leaves(params, grads, state.velocity)
        for p, g, vel in zip(ps, gs, vels):
            vel_new = momentum * vel + g.float()
            _keep(keep, (p.float() - _per_member(lrs, p) * vel_new)
                  .to(p.dtype), p)
            _keep(keep, vel_new, vel)
        step = torch.where(keep, state.step + 1, state.step)
        return params, SGDState(step, state.velocity), {"lr": lrs}

    return init, update
