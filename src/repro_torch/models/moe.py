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

On a mesh (`sharding.spmd`) the load-balance loss is the global batch's,
as the reference's one program over the whole batch computes it: the
router's mean probabilities and the routed fractions are each rank's
rows' means made global over the batch dims' groups the step hands in
(`spmd.global_batch_mean`) before their product.
With a tensor-parallel context (`sharding.tp`, `tp.experts`) the
routing, the slots and the aux losses run whole on every rank of the
model axis (the same rows, so the same drops), and only the experts
split: a rank scatters its own experts' kept entries into a (B, Ep/tp,
C, d) buffer and runs them ("expert"), or runs the whole buffer through
its columns of every expert ("d_ff"); the mixed output is summed over
the ranks.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import ACTIVATIONS, dense_init, uniform_init
from repro_torch.obs import trace as otrace
from repro_torch.sharding import spmd
from repro_torch.sharding import tp as TP
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


def moe_ffn(params, cfg, x, *, want_aux: bool = False, tp=None,
            batch_groups=()):
    """x: (B, S, d) -> (out (B, S, d), aux). One dispatch group per row.
    aux is None unless `want_aux`; then {"load_balance", "router_z",
    "dropped_frac"}, f32 scalars, as the reference returns them; with
    `batch_groups` (`spmd.batch_groups`: x is this rank's rows of a split
    batch) the load balance is the global batch's. With a
    tensor-parallel context whose experts split (`tp.experts`), params
    hold this rank's shards of the expert weights and the router whole."""
    m = cfg.moe
    B, S, d = x.shape
    E, K, Ep = m.n_experts, m.top_k, m.padded_n_experts
    C = capacity(cfg, S)

    with otrace.region("moe.route") as rg:
        logits = (x @ params["router"]).float()                  # (B, S, E)
        gate_vals, idx = route(logits, K)                        # (B, S, K)
        weights = torch.softmax(gate_vals, dim=-1).to(x.dtype)

        # --- slots: token-major, k-minor order; past capacity is dropped
        flat_e = idx.reshape(B, S * K)
        onehot = (flat_e[..., None] == torch.arange(Ep, device=x.device)) \
            .to(torch.int32)                                     # (B, SK, Ep)
        pos = (torch.cumsum(onehot, dim=1, dtype=torch.int32) * onehot) \
            .sum(-1) - 1
        keep = pos < C

        # --- aux losses (before the experts, as the reference orders
        # them: a recomputed forward then stops before the experts'
        # all-reduce) ---
        aux = None
        if want_aux:
            probs = torch.softmax(logits, dim=-1)
            me = probs.mean(dim=(0, 1))
            ce = (idx[..., None] == torch.arange(E, device=x.device)) \
                .float().sum(dim=2).mean(dim=(0, 1)) / K
            me, ce = spmd.global_batch_mean(torch.stack([me, ce]),
                                            batch_groups)
            aux = {"load_balance": E * (me * ce).sum(),
                   "router_z": (torch.logsumexp(logits, dim=-1) ** 2).mean(),
                   "dropped_frac": 1.0 - keep.float().mean()}

        if tp is None:
            return _experts(params, cfg, x, weights, flat_e, pos, keep,
                            range(Ep), C, rg), aux
        return TP.reduce_from_model(_experts(
            params, cfg, TP.copy_to_model(x, tp),
            TP.copy_to_model(weights, tp), flat_e, pos, keep,
            tp.local_experts(cfg), C, rg), tp), aux


def _experts(params, cfg, x, weights, flat_e, pos, keep, experts: range, C,
             rg):
    """Dispatch, the `experts` (a range of the padded experts: the expert
    weights' leading dim), combine. The kept entries routed to them are
    scatter-added into a (B, len(experts), C, d) buffer, each expert runs
    on its C slots, and each entry's output is gathered back and mixed by
    its gate weight (the other entries add zero). `rg` is the caller's
    open `obs.trace` region, switched to each of the three in turn."""
    B, S, d = x.shape
    SK = flat_e.shape[1]
    K = SK // S
    lo, n = experts.start, len(experts)
    rg.switch("moe.dispatch")
    if n == cfg.moe.padded_n_experts:           # all of them: no filter
        mine, slot = keep, flat_e * C + torch.where(keep, pos, 0)
    else:
        mine = keep & (flat_e >= lo) & (flat_e < lo + n)
        slot = torch.where(mine, (flat_e - lo) * C + pos, 0)     # (B, SK)
    tok = torch.arange(SK, device=x.device) // K
    src = torch.where(mine[..., None], x[:, tok], 0)             # (B, SK, d)
    index = slot[..., None].expand(B, SK, d)
    buf = torch.zeros((B, n * C, d), dtype=x.dtype, device=x.device) \
        .scatter_add(1, index, src).view(B, n, C, d)
    buf = constrain(buf, ("batch", "model", None, None))         # (B,E,C,d)

    # --- experts: (B, n, C, d) x (n, d, ff) ---
    rg.switch("moe.experts")
    act = ACTIVATIONS[cfg.act]
    h = act(torch.einsum("becd,edf->becf", buf, params["w_gate"])) \
        * torch.einsum("becd,edf->becf", buf, params["w_up"])
    out_buf = torch.einsum("becf,efd->becd", h, params["w_down"])
    out_buf = constrain(out_buf, ("batch", "model", None, None))

    # --- combine ---
    rg.switch("moe.combine")
    gathered = torch.gather(out_buf.reshape(B, n * C, d), 1, index)
    gathered = torch.where(mine[..., None], gathered, 0)
    return (gathered * weights.reshape(B, SK, 1)).reshape(B, S, K, d) \
        .sum(dim=2)
