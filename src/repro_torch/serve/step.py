"""Serving step builders: full prefill and single-token decode on the dense
layout (plus `prefill_into_cache`, which copies a prefill's caches into the
fixed decode cache); on the paged layout suffix prefill, decode, the fused
N-token greedy decode, the speculative draft-verify step and the chunked
scheduler's mixed decode + chunk step.

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


def build_decode_fused(cfg, n_tokens: int, *, window=None,
                       kernel: str = "cuda"):
    """Multi-token greedy decode in one dispatch: `n_tokens` paged decode
    steps, with the sequencing the engine would do between steps done on
    the device. Each iteration writes the carried token at its slot's
    position, takes the argmax, and masks the slot dead on EOS or an
    exhausted budget. Dead slots keep running harmlessly: their table rows
    are swapped for the all-zero row, so their writes land in the null
    page and their emitted tokens read -1.

    The body is the reference's `lax.scan` unrolled into a loop of torch
    ops with no host synchronisation (no `.item()`, no boolean-mask
    indexing): masks go through `torch.where`, so the whole loop can be
    captured as one CUDA graph (`serve.graph.FusedDecodeGraph`, the
    engine's stand-in for the reference's `jax.jit`).

    fused(params, tokens, pos, cache, table, eos, live, steps) ->
        (emitted, live, steps, cache)
      tokens (B,1) int32: last emitted token per slot
      pos    (B,)  int32: position that token will be written at
      eos    (B,)  int32: per-slot EOS id, -1 = no EOS
      live   (B,)  bool:  slots taking part in this dispatch
      steps  (B,)  int32: per-slot remaining token budget
      emitted (n_tokens, B) int32: generated tokens, -1 past a slot's end
    The engine reconciles on exit: per slot it takes the emitted tokens up
    to the first -1, advances pos and budget by the steps taken (steps_in
    - steps_out), and retires slots whose live flag dropped. Greedy only:
    a slot that samples on the host makes the engine take single steps."""
    def fused(params, tokens, pos, cache, table, eos, live, steps):
        tok, p, lv, st = tokens, pos, live, steps
        emitted = []
        for _ in range(n_tokens):
            tbl = torch.where(lv[:, None], table, 0)
            logits, cache = T.decode_step_paged(params, cfg, tok, p, cache,
                                                tbl, window=window,
                                                kernel=kernel)
            nxt = _greedy(logits[:, -1, :])
            hit_eos = lv & (eos >= 0) & (nxt == eos)
            emitted.append(torch.where(lv & ~hit_eos, nxt, -1))
            st = torch.where(lv, st - 1, st)
            lv = lv & ~hit_eos & (st > 0)
            tok = torch.where(lv, nxt, tok[:, 0])[:, None]
            p = torch.where(lv, p + 1, p)
        return torch.stack(emitted), lv, st, cache
    return fused


def build_decode_spec(cfg, k: int, *, window=None):
    """Speculative draft-verify decode: up to k+1 greedy tokens per
    dispatch from ONE batched forward (`transformer.verify_step_paged`).

    Per slot, the carried token t0 (at position p0) and k drafted tokens
    run through the model at positions p0..p0+k in one causal forward. The
    greedy argmax at each position verifies the drafts (draft j is
    accepted iff it equals the argmax at position j-1, prefix-wise) and
    gives the bonus token after the last accepted draft. Acceptance, EOS
    and budgets are masked on the device; the engine reconciles like the
    fused path.

    spec(params, tokens, pos, cache, table, inp) -> (out, cache)
      tokens (B,1) int32: last emitted token per slot (written at pos)
      inp    (B,k+3) int32, packed per-slot operands (one host-to-device
             copy instead of four):
        cols 0..k-1  draft: proposed continuations (serve.draft)
        col  k       eos, col k+1 steps, col k+2 live (0/1), as in
                     `build_decode_fused`
    `out` is one (k+5, B) int32 tensor (one copy back to the host):
      rows 0..k  emitted: accepted + bonus tokens, -1 past a slot's end
      row  k+1   adv: positions advanced, the written draft tokens that
                 stay valid; the engine rewinds its frontier to pos + adv
                 and rolls the rest back (KVCacheManager.rollback)
      row  k+2   n_acc: drafts matching the model (acceptance telemetry,
                 before EOS and budget truncation)
      row  k+3   live (0/1) and row k+4 steps, as in the fused path
    Rejected drafts' K/V rows (positions beyond pos + adv) stay in the
    pool, but every read masks positions past the frontier, so the rewind
    is the rollback on the device; the next dispatch overwrites them."""
    def spec(params, tokens, pos, cache, table, inp):
        draft = inp[:, :k]
        eos = inp[:, k]
        steps = inp[:, k + 1]
        live = inp[:, k + 2].bool()
        tbl = torch.where(live[:, None], table, 0)
        seq = torch.cat([tokens, draft], dim=1)               # (B, k+1)
        logits, cache = T.verify_step_paged(params, cfg, seq, pos, cache,
                                            tbl, window=window)
        g = _greedy(logits)                                   # (B, k+1)
        # drafts accepted prefix-wise: draft j is valid iff it equals the
        # model's next token at the previous position
        acc = torch.cumprod((draft == g[:, :-1]).to(torch.int32), dim=1)
        n_acc = acc.sum(dim=1)                                # (B,)
        j = torch.arange(k + 1, device=g.device)[None, :]
        cand = (j <= n_acc[:, None]) & (j < steps[:, None]) & live[:, None]
        is_eos = (eos[:, None] >= 0) & (g == eos[:, None])
        # an EOS candidate stops emission at itself (EOS is never emitted)
        blocked = torch.cumsum((cand & is_eos).to(torch.int32), dim=1) > 0
        keep = cand & ~blocked
        emitted = torch.where(keep, g, -1).T                  # (k+1, B)
        n_emit = keep.sum(dim=1)
        adv = torch.minimum(n_emit, n_acc)
        hit_eos = (cand & is_eos).any(dim=1)
        steps = steps - n_emit
        live = live & ~hit_eos & (steps > 0)
        out = torch.cat([emitted] + [r[None].to(torch.int32)
                                     for r in (adv, n_acc, live, steps)])
        return out, cache
    return spec


def build_mixed_step(cfg, *, window=None, kernel: str = "cuda",
                     return_logits: bool = False):
    """One chunked-prefill scheduler iteration in one dispatch: a lockstep
    single-token decode over every decoding slot plus one bounded prefill
    chunk of a partly prefilled slot, through one pass over the stack
    (`transformer.mixed_step_paged`, one combined pool write per layer).
    The chunk operand has a fixed length, the engine's chunk budget; a
    short chunk is right-padded.

    mixed(params, tokens, pos, cache, table, ctoks, cstart, cn, ctable)
        -> (decode_out, chunk_out, cache)
      tokens (B,1) / pos (B,) int32 / table (B,nb): the decode operands,
        with the rows of slots that do not decode zeroed (their writes
        land in the null page; the engine ignores their outputs);
      ctoks (1, C) int32: the chunk's tokens; cstart (int): its absolute
        start position; cn (int): its real-token count; ctable: the
        prefilling slot's block chain truncated to the pages the chunk can
        causally see (the engine rounds the page count up to a power of
        two, as the reference does to bound its retraces, so both gather
        the same span).
      decode_out: per-slot greedy token (B,) or last-position logits
        (B, V); chunk_out: the greedy token () or logits (V,) at the
        chunk's last real position, meaningful only when the chunk
        completes its prompt (the deferred first token)."""
    def mixed(params, tokens, pos, cache, table, ctoks, cstart, cn, ctable):
        B = tokens.shape[0]
        C = ctoks.shape[1]
        all_toks = torch.cat([tokens[:, 0], ctoks[0]])
        all_pos = torch.cat([pos, cstart + torch.arange(
            C, dtype=pos.dtype, device=pos.device)])
        logits, cache = T.mixed_step_paged(params, cfg, all_toks, all_pos,
                                           cn, cache, table, ctable,
                                           window=window, kernel=kernel)
        last = logits[B + cn - 1]
        if return_logits:
            return logits[:B], last, cache
        return _greedy(logits[:B]), _greedy(last), cache
    return mixed
