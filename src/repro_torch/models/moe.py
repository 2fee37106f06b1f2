"""Token-choice top-k Mixture-of-Experts FFN (granite-3.0 style), the port
of `repro.models.moe`.

Dispatch is GShard-grouped and scatter-based, as in the reference: each
row of `x` is one dispatch group with a fixed capacity of C slots per
expert, the kept tokens are scatter-added into an (B, Ep, C, d) buffer,
the experts run as batched products over that buffer, and each token's K
expert outputs are gathered back and mixed by its gate weights. The
reference's arithmetic choices are copied, not re-derived:

* C = int(max(K, round(S * K * capacity_factor / E))), Python's `round`
  on the group's length S, pads included.
* Slots are taken in the flattened (S*K) token-major, k-minor order, from
  a cumulative sum of one-hots; an entry past capacity is dropped, and a
  dropped entry scatter-adds zero at slot 0.
* The router product runs in the activation dtype and is then cast to
  f32; the top K of the real E experts are taken, lower index first on a
  tie as `lax.top_k` does (a stable descending sort: `torch.topk` breaks
  ties in no fixed order), and softmax over those K logits gives the gate
  weights, cast to the activation dtype before the combine.
* The buffer and the expert weights are `padded_n_experts` wide; the
  router stays `n_experts` wide, so a padded expert is never chosen.

Everything has fixed shapes and no host synchronisation (no `.item()`,
`nonzero` or boolean-mask indexing), so the fused decode step that runs
it can be captured as one CUDA graph. The aux losses (Switch/GShard load
balance, the router z-loss, the dropped fraction) are computed only when
the caller asks (`want_aux`, training): the reference's serving paths
discard them and XLA removes that code.

The expert products are `torch.einsum` (batched matrix products), as the
reference's are `jnp.einsum` outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import ACTIVATIONS, dense_init, uniform_init
from repro_torch.sharding.rules import constrain


def init_moe(gen: torch.Generator, cfg) -> dict:
    """Router (d, E) at scale 0.02 and expert weights stacked on a leading
    `padded_n_experts` axis, uniform +-1/sqrt(d_in) as the reference's."""
    m = cfg.moe
    d, ff = cfg.d_model, m.expert_d_ff
    E, Ep = m.n_experts, m.padded_n_experts
    pdt = cfg.parameter_dtype
    return {
        "router": dense_init(gen, d, E, pdt, scale=0.02),
        "w_gate": uniform_init(gen, (Ep, d, ff), 1.0 / math.sqrt(d), pdt),
        "w_up": uniform_init(gen, (Ep, d, ff), 1.0 / math.sqrt(d), pdt),
        "w_down": uniform_init(gen, (Ep, ff, d), 1.0 / math.sqrt(ff), pdt),
    }


def param_shapes(cfg) -> dict:
    m = cfg.moe
    d, ff, Ep = cfg.d_model, m.expert_d_ff, m.padded_n_experts
    return {"router": (d, m.n_experts), "w_gate": (Ep, d, ff),
            "w_up": (Ep, d, ff), "w_down": (Ep, ff, d)}


def capacity(cfg, S: int) -> int:
    """Slots per expert for a group of S tokens (the reference's line)."""
    m = cfg.moe
    K, E = m.top_k, m.n_experts
    return int(max(K, round(S * K * m.capacity_factor / E)))


def route(logits, K: int):
    """Top-K over the last axis, lower index first on a tie (`lax.top_k`'s
    order). Returns (values, indices)."""
    vals, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :K], order[..., :K]


def moe_ffn(params, cfg, x, *, want_aux: bool = False):
    """x: (B, S, d) -> (out (B, S, d), aux). One dispatch group per row.
    aux is None unless `want_aux`; then {"load_balance", "router_z",
    "dropped_frac"}, f32 scalars, as the reference returns them."""
    m = cfg.moe
    B, S, d = x.shape
    E, K, Ep = m.n_experts, m.top_k, m.padded_n_experts
    C = capacity(cfg, S)

    logits = (x @ params["router"]).float()                      # (B, S, E)
    gate_vals, idx = route(logits, K)                            # (B, S, K)
    weights = torch.softmax(gate_vals, dim=-1).to(x.dtype)

    # --- slots: token-major, k-minor order; past capacity is dropped ---
    flat_e = idx.reshape(B, S * K)
    onehot = (flat_e[..., None] == torch.arange(Ep, device=x.device)) \
        .to(torch.int32)                                         # (B, SK, Ep)
    pos = (torch.cumsum(onehot, dim=1, dtype=torch.int32) * onehot) \
        .sum(-1) - 1
    keep = pos < C
    slot = flat_e * C + torch.where(keep, pos, 0)                # (B, SK)
    tok = torch.arange(S * K, device=x.device) // K
    src = torch.where(keep[..., None], x[:, tok], 0)             # (B, SK, d)
    index = slot[..., None].expand(B, S * K, d)
    buf = torch.zeros((B, Ep * C, d), dtype=x.dtype, device=x.device) \
        .scatter_add(1, index, src).view(B, Ep, C, d)
    buf = constrain(buf, ("batch", "model", None, None))         # (B,E,C,d)

    # --- experts: (B, Ep, C, d) x (Ep, d, ff) ---
    act = ACTIVATIONS[cfg.act]
    h = act(torch.einsum("becd,edf->becf", buf, params["w_gate"])) \
        * torch.einsum("becd,edf->becf", buf, params["w_up"])
    out_buf = torch.einsum("becf,efd->becd", h, params["w_down"])
    out_buf = constrain(out_buf, ("batch", "model", None, None))

    # --- combine ---
    gathered = torch.gather(out_buf.reshape(B, Ep * C, d), 1, index)
    gathered = torch.where(keep[..., None], gathered, 0)
    out = (gathered * weights.reshape(B, S * K, 1)).reshape(B, S, K, d) \
        .sum(dim=2)
    if not want_aux:
        return out, None

    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=(0, 1))
    ce = (idx[..., None] == torch.arange(E, device=x.device)).float() \
        .sum(dim=2).mean(dim=(0, 1)) / K
    aux = {"load_balance": E * (me * ce).sum(),
           "router_z": (torch.logsumexp(logits, dim=-1) ** 2).mean(),
           "dropped_frac": 1.0 - keep.float().mean()}
    return out, aux
