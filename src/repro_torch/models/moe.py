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

Two port-only parts (`MoEConfig`'s `held_experts`/`first_held` and
`shared_d_ff`, off by default): a layer told that it holds a range of the
experts of an expert-parallel deployment routes over all `n_experts` with
the same slots and drops, and computes its own experts' part of the
result (the rest is left out: on one device it runs without the
exchange), and a SiLU-gated shared expert runs on every token and is
added to the routed output (granite-4.0-h).

Everything has fixed shapes and no host synchronisation (no `.item()`,
`nonzero` or boolean-mask indexing), so the fused decode step that runs
it can be captured as one CUDA graph. The aux losses (Switch/GShard load
balance, the router z-loss, the dropped fraction) are computed only when
the caller asks (`want_aux`, training): the reference's serving paths
discard them and XLA removes that code.

The expert products are `torch.einsum` (batched matrix products), as the
reference's are `jnp.einsum` outside any Pallas kernel. Where no entry of a
group can be dropped (C >= S: a decode position, a speculative
verification of k+1 <= C tokens, a prompt no longer than C), the kernel
takes the experts' shapes and no gradient is taken, the port instead runs
the routed experts as a grouped product over the live (token, expert)
entries (`kernels.moe_experts`: the hand-written kernel on CUDA tensors,
its plain version on CPU ones): the same function, without the (B, E, C,
d) buffer that is nearly all empty there. Every other case (prefill at
S > C, training, the chunked step's mixed group, the tensor-parallel
experts, widths the kernel does not take) runs the buffer path.

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

from repro_torch.kernels.moe_experts import ops as ME
from repro_torch.models.layers import (ACTIVATIONS, dense_init, init_mlp,
                                      mlp, uniform_init)
from repro_torch.obs import trace as otrace
from repro_torch.sharding import spmd
from repro_torch.sharding import tp as TP
from repro_torch.sharding.rules import constrain


def init_moe(gen: torch.Generator, cfg) -> dict:
    """Router (d, E) at scale 0.02 and expert weights stacked on a leading
    `padded_n_experts` axis (`n_held` where the layer holds a share),
    uniform +-1/sqrt(d_in) as the reference's; a shared expert as a gated
    MLP."""
    m = cfg.moe
    d, ff = cfg.d_model, m.expert_d_ff
    E, Ep = m.n_experts, m.n_held
    pdt = cfg.parameter_dtype
    p = {
        "router": dense_init(gen, d, E, pdt, scale=0.02),
        "w_gate": uniform_init(gen, (Ep, d, ff), 1.0 / math.sqrt(d), pdt),
        "w_up": uniform_init(gen, (Ep, d, ff), 1.0 / math.sqrt(d), pdt),
        "w_down": uniform_init(gen, (Ep, ff, d), 1.0 / math.sqrt(ff), pdt),
    }
    if m.shared_d_ff:
        p["shared"] = init_mlp(gen, d, m.shared_d_ff, pdt)
    return p


def param_shapes(cfg) -> dict:
    m = cfg.moe
    d, ff, Ep = cfg.d_model, m.expert_d_ff, m.n_held
    out = {"router": (d, m.n_experts), "w_gate": (Ep, d, ff),
           "w_up": (Ep, d, ff), "w_down": (Ep, ff, d)}
    if m.shared_d_ff:
        fs = m.shared_d_ff
        out["shared"] = {"w_gate": (d, fs), "w_up": (d, fs),
                         "w_down": (fs, d)}
    return out


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
    hold this rank's shards of the expert weights and the router whole.
    A layer holding a share of the experts (`held_experts`) computes
    theirs; a shared expert's output is added last ("moe.shared")."""
    m = cfg.moe
    if tp is not None and (m.held_experts or m.shared_d_ff):
        raise ValueError(f"{cfg.arch_id}: no tensor-parallel MoE with held "
                         "experts or a shared expert")
    if m.held.stop > m.padded_n_experts:
        raise ValueError(f"{cfg.arch_id}: experts {m.held} held, the router "
                         f"has {m.padded_n_experts}")
    out, aux = _routed(params, cfg, x, want_aux, tp, batch_groups)
    if m.shared_d_ff:
        with otrace.region("moe.shared"):
            out = out + mlp(params["shared"], x, cfg.act)
    return out, aux


def grouped(cfg, S: int, tp=None) -> bool:
    """Whether a group of S tokens runs the grouped experts: no entry can
    be dropped (a token's K experts are distinct, so an expert receives at
    most S entries of a group, and C >= S holds them all), the experts are
    not split over a tensor-parallel axis, and the kernel takes their
    widths, count, dtype and activation (`moe_experts.takes`; on every
    device, so the CPU and the card choose alike)."""
    m = cfg.moe
    return (tp is None and capacity(cfg, S) >= S
            and ME.takes(cfg.d_model, m.expert_d_ff, m.n_held,
                         cfg.activation_dtype, cfg.act))


def _takes_grad(params, x) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(
        params[k].requires_grad for k in ("router", "w_gate", "w_up",
                                          "w_down")))


def _routed(params, cfg, x, want_aux, tp, batch_groups):
    m = cfg.moe
    B, S, d = x.shape
    E, K, Ep = m.n_experts, m.top_k, m.padded_n_experts
    C = capacity(cfg, S)
    # the kernel has no backward: a gradient keeps the buffer path
    keep_all = grouped(cfg, S, tp) and not _takes_grad(params, x)

    with otrace.region("moe.route") as rg:
        logits = (x @ params["router"]).float()                  # (B, S, E)
        gate_vals, idx = route(logits, K)                        # (B, S, K)
        weights = torch.softmax(gate_vals, dim=-1).to(x.dtype)

        # --- slots: token-major, k-minor order; past capacity is dropped
        # (where C >= S no entry is: the grouped path needs no slots)
        flat_e = idx.reshape(B, S * K)
        if not keep_all:
            onehot = (flat_e[..., None] == torch.arange(Ep, device=x.device)) \
                .to(torch.int32)                                 # (B, SK, Ep)
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
                   "dropped_frac": logits.new_zeros(()) if keep_all
                   else 1.0 - keep.float().mean()}

        if keep_all:
            return _grouped(params, cfg, x, weights, flat_e, m.held, rg), aux
        if tp is None:
            return _experts(params, cfg, x, weights, flat_e, pos, keep,
                            m.held, C, rg), aux
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


def _grouped(params, cfg, x, weights, flat_e, experts: range, rg):
    """Dispatch, the `experts` and combine for groups in which every entry
    is kept: the B*S*K entries ordered by expert (`moe_dispatch`), each
    held expert run on the rows that chose it (`moe_experts`, y in entry
    order, zeros for the entries of experts not held), then the buffer
    path's combine."""
    B, S, d = x.shape
    N = flat_e.numel()
    K = N // (B * S)
    rg.switch("moe.dispatch")
    perm, offsets = ME.moe_dispatch(flat_e.reshape(N), experts.start,
                                    len(experts))
    rg.switch("moe.experts")
    y = ME.moe_experts(x.reshape(B * S, d), perm, offsets, params["w_gate"],
                       params["w_up"], params["w_down"], top_k=K,
                       act=cfg.act)
    rg.switch("moe.combine")
    return (y * weights.reshape(N, 1)).reshape(B, S, K, d).sum(dim=2)
