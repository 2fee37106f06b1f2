"""Loss functions for the LM zoo (the reference's `repro.train.losses`).

The reference extracts the label's logit with a masked sum over the vocab
axis, because a gather along a sharded axis makes GSPMD all-gather the
logits; nothing is sharded here, so the port gathers."""
from __future__ import annotations

import torch


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


def lm_loss(params, cfg, batch, forward_fn, *, window=None):
    """Cross-entropy + MoE aux (`load_balance_coef * load_balance +
    router_z_coef * router_z`). Returns (loss, metrics)."""
    logits, aux = forward_fn(params, cfg, batch, window=window)
    xent = softmax_xent(logits, batch["labels"], batch.get("mask"))
    loss = xent
    if cfg.moe:
        loss = loss + cfg.moe.load_balance_coef * aux["load_balance"] \
                    + cfg.moe.router_z_coef * aux["router_z"]
    metrics = {"xent": xent, "loss": loss}
    metrics.update(aux)
    return loss, metrics
