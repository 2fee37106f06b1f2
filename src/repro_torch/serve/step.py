"""Serving step builders for the paged layout: suffix prefill (pool write)
and single-token decode.

The reference jits these closures; the port runs them eagerly, so they are
plain closures over the config with the reference's call contracts.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T


def bucket_len(n: int, cap: int) -> int:
    """Round a sequence length up to a power of two (capped). The reference
    buckets to bound its jit retraces; the port keeps the same buckets so
    both run the same padded shapes (and the same pad positions reach the
    null block)."""
    b = 1
    while b < n:
        b *= 2
    if cap and b > cap:
        return max(cap, n)      # never round *down* below the real length
    return b


def _greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def build_decode_paged(cfg, *, window=None, return_logits: bool = False,
                       kernel: str = "cuda"):
    """Decode over block tables: scatter the new token's K/V into its
    frontier page, then attend over the slot's page chain (see
    `transformer.decode_step_paged`). `kernel` picks the attention read:
    "reference" gathers the chain into a dense view, "cuda" streams pages
    from the pool (kernels/paged_attention).

    decode(params, tokens (B,1), pos (B,), cache, table (B,nb)) ->
        (greedy tokens (B,) int32 | last-position logits (B,V), cache)"""
    def decode(params, tokens, pos, cache, table):
        logits, cache = T.decode_step_paged(params, cfg, tokens, pos, cache,
                                            table, window=window,
                                            kernel=kernel)
        last = logits[:, -1, :]
        return (last if return_logits else _greedy(last)), cache
    return decode


def build_prefill_paged(cfg, *, window=None, return_logits: bool = False):
    """Suffix-only prefill on a prefix-cache hit: `tokens` (1, S_bucket) are
    the uncached prompt tail starting at absolute position `start`
    (`n_tok` real, rest right-pad); the resident prefix pages are attended
    through the slot's block `table`. Emits the last real position's
    greedy token / logits plus the updated pool."""
    def prefill(params, tokens, start, n_tok, cache, table):
        logits, cache = T.forward_prefill_paged(
            params, cfg, tokens, start, n_tok, cache, table, window=window)
        last = logits[0, n_tok - 1]
        return (last if return_logits else _greedy(last)), cache
    return prefill
