"""Loss functions for the LM zoo (the reference's `repro.train.losses`).

The reference extracts the label's logit with a masked sum over the vocab
axis, because a gather along a sharded axis makes GSPMD all-gather the
logits; the port's one-device logits are whole, so it gathers, and its
tensor-parallel loss (`sharding.tp.vocab_parallel_xent`) gathers within
the rank's vocabulary slice under a mask."""
from __future__ import annotations

import functools

import torch

from repro_torch.sharding import tp as TP


def softmax_xent(logits, labels, mask=None, label_smoothing: float = 0.0):
    """logits: (..., V); labels: (...) int; mask: (...) optional {0, 1}.
    Mean token cross-entropy in float32 (masked: over the masked-in tokens,
    at least one)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if label_smoothing > 0:
        # uniform-smoothing cross-entropy (constant -ls*log(V) term dropped)
        nll = (1 - label_smoothing) * nll \
            + label_smoothing * (lse - logits.mean(dim=-1))
    if mask is not None:
        denom = torch.clamp(mask.sum(), min=1.0)
        return (nll * mask).sum() / denom
    return nll.mean()


def lm_loss(params, cfg, batch, forward_fn, *, window=None, tp=None,
            batch_groups=()):
    """Cross-entropy + MoE aux (`load_balance_coef * load_balance +
    router_z_coef * router_z`). Returns (loss, metrics). With a tensor-
    parallel context (`sharding.tp`) the forward runs under it, and the
    loss of vocab-split logits is `tp.vocab_parallel_xent`. With
    `batch_groups` (`sharding.spmd.batch_groups`: `batch` is this rank's
    rows of a split batch) the forward takes the MoE load balance over the
    global batch."""
    kw = {} if tp is None else {"tp": tp}
    if batch_groups:
        kw["batch_groups"] = batch_groups
    logits, aux = forward_fn(params, cfg, batch, window=window, **kw)
    xent_fn = softmax_xent
    if tp is not None and tp.vocab:
        xent_fn = functools.partial(TP.vocab_parallel_xent, tp=tp)
    xent = xent_fn(logits, batch["labels"], batch.get("mask"))
    loss = xent
    if cfg.moe:
        loss = loss + cfg.moe.load_balance_coef * aux["load_balance"] \
                    + cfg.moe.router_z_coef * aux["router_z"]
    metrics = {"xent": xent, "loss": loss}
    metrics.update(aux)
    return loss, metrics
