"""Serving step builders: full prefill and single-token decode on the dense
layout (plus `prefill_into_cache`, which copies a prefill's caches into the
fixed decode cache), and suffix prefill and decode on the paged layout.

The reference jits these closures; the port runs them eagerly, so they are
plain closures over the config with the reference's call contracts. One
addition: the dense decode takes the batch rows it may write (`rows`),
because the port updates the cache in place where the reference returns a
new one and merges rows afterwards.
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


def build_prefill(cfg, *, window=None, return_logits: bool = False):
    """prefill(params, batch) -> (greedy next token (B,) int32 | last-
    position logits (B, V), caches at natural length)."""
    def prefill(params, batch):
        logits, caches = T.forward_prefill(params, cfg, batch, window=window)
        last = logits[:, -1, :]
        return (last if return_logits else _greedy(last)), caches
    return prefill


def build_decode(cfg, *, window=None, return_logits: bool = False):
    """decode(params, tokens (B,1), pos (B,), cache, rows=None) ->
    (greedy tokens (B,) int32 | last-position logits (B,V), cache); only
    the cache rows in `rows` (None = all) are written
    (`transformer.decode_step`)."""
    def decode(params, tokens, pos, cache, rows=None):
        logits, cache = T.decode_step(params, cfg, tokens, pos, cache,
                                      window=window, rows=rows)
        last = logits[:, -1, :]
        return (last if return_logits else _greedy(last)), cache
    return decode


def build_prefill_bucketed(cfg, *, window=None, return_logits: bool = False):
    """Dense bulk prefill for right-padded prompts: like `build_prefill`
    but reads the last *real* position (`n_tok - 1`) instead of the last
    column, so prompts padded to the same power-of-two bucket share a
    shape. prefill(params, batch, n_tok) -> (token | logits, caches)."""
    def prefill(params, batch, n_tok):
        logits, caches = T.forward_prefill(params, cfg, batch, window=window)
        last = logits[:, n_tok - 1]                      # (B, V)
        return (last if return_logits else _greedy(last)), caches
    return prefill


def prefill_into_cache(cfg, caches, cache, prompt_lens):
    """Copy natural-length prefill caches into the fixed-size decode cache.

    caches: output of forward_prefill (k/v at prompt length S_p, possibly
    right-padded past the real prompts). cache: the decode cache (length
    >= S_p, or a ring for window caches), written in place. prompt_lens:
    (B,) real prompt lengths; entries at positions >= prompt_lens[b] are
    padding and get pos = -1 so decode masks them. Attention entries keep
    the last min(Sc, S_p) positions, at slot = pos % Sc, so linear and ring
    caches follow one rule. Recurrent states (RG-LRU, Mamba2) are final
    after the prefill and are taken as they are. Returns the updated cache
    list.
    """
    out = []
    for dst, src in zip(cache, caches):
        if "k" not in dst:              # rglru / ssm: state already final
            out.append(src)
            continue
        Sc = dst["k"].shape[1]
        take = min(Sc, src["k"].shape[1])
        ksrc, vsrc, psrc = (a[:, -take:] for a in
                            (src["k"], src["v"], src["pos"]))
        lens = torch.as_tensor(prompt_lens, device=psrc.device)
        slots = (psrc % Sc).long()                        # (B, take)
        bidx = torch.arange(ksrc.shape[0], device=psrc.device)[:, None]
        pvals = torch.where(psrc < lens[:, None], psrc, -1)
        dst["k"][bidx, slots] = ksrc.to(dst["k"].dtype)
        dst["v"][bidx, slots] = vsrc.to(dst["v"].dtype)
        dst["pos"][bidx, slots] = pvals.to(dst["pos"].dtype)
        out.append(dst)
    return out


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
