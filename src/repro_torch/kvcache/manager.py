"""KVCacheManager: the host-side brain of the paged KV cache.

Ties together the three pieces — `BlockPool` (refcounted page ids),
`RadixTree` (prefix -> block chains), `CacheMetrics` (hit/miss/eviction
counters) — behind the narrow API the `ServeEngine` drives:

    admit(prompt, total_tokens) -> Admission   # match + CoW + alloc (+ evict)
    cow_done(src)                              # engine finished the device copy
    commit(tokens, blocks)                     # index prefilled full blocks
    release(blocks)                            # request retired / evicted

The manager never touches device memory: an `Admission` tells the engine
*which* pool rows to gather/scatter/copy, and the engine performs the tensor
ops on its pool arrays. That split keeps every invariant (refcount
conservation, no double free, eviction-safety of in-use chains) testable
with plain-Python property tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.kvcache.block_pool import BlockPool, PoolExhausted
from repro_torch.kvcache.metrics import CacheMetrics
from repro_torch.kvcache.radix import RadixTree

__all__ = ["Admission", "KVCacheManager", "PoolExhausted"]


@dataclass
class Admission:
    """One request's slice of the pool, ready to use.

    blocks:   the full block chain for the request's table, in order —
              shared radix blocks first (extra ref taken), then fresh ones.
    n_reused: prompt tokens whose KV is already resident (the engine
              prefills only prompt[n_reused:]).
    cow:      (src, dst) when n_reused ends inside a cached block: the
              engine must device-copy pool row src -> dst, then call
              `cow_done(src)`. dst is already in `blocks`.
    """
    blocks: List[int]
    n_reused: int
    cow: Optional[Tuple[int, int]] = None
    fresh: List[int] = field(default_factory=list)


class KVCacheManager:
    def __init__(self, n_blocks: int, block_size: int):
        self.pool = BlockPool(n_blocks, block_size)
        self.radix = RadixTree(block_size, self.pool)
        self.metrics = CacheMetrics()

    # ------------------------------------------------------------ admission
    def admit(self, prompt, total_tokens: int) -> Admission:
        """Reserve blocks covering `total_tokens` positions for a request
        with this prompt, reusing the longest cached prefix. Evicts cold
        radix chains under pressure; raises PoolExhausted (reserving
        nothing) if the pool still cannot cover the request."""
        bs = self.pool.block_size
        n_total = max(1, -(-total_tokens // bs))        # ceil
        # cap reuse at len(prompt)-1: at least one prompt token must run
        # through the model so there are last-position logits to sample
        shared, partial = self.radix.match(prompt[:max(len(prompt) - 1, 0)])
        n_new = n_total - len(shared)
        if n_new < 0:                                   # tiny total budget
            shared, partial, n_new = shared[:n_total], None, 0
        try:
            self.pool.incref(shared)                    # pin before evicting
        except ValueError:
            # a matched block was concurrently freed (cannot happen in the
            # single-threaded engine, but keep the failure non-destructive)
            raise PoolExhausted("matched prefix vanished during admission")
        # pin the CoW source NOW, before eviction/allocation: with only a
        # tree ref it is a legal LRU victim, and the LIFO free list would
        # hand it back as one of this very request's fresh blocks — the
        # admission would then claim its tokens as resident while the page
        # holds garbage (silently wrong attention, no error)
        cow_src = None
        if partial is not None and n_new > 0:
            cow_src = partial[0]
            self.pool.incref([cow_src])

        def unpin():
            self.pool.decref(shared)
            if cow_src is not None:
                self.pool.decref([cow_src])

        need = n_new - self.pool.free_count()
        if need > 0:
            # don't flush the cache for a request that cannot fit anyway.
            # Exact count: an idle block buried under an in-use descendant
            # is NOT reclaimable (evict only trims chain tails), so the
            # naive ref==1 scan would evict less than promised here and
            # fail the alloc below anyway
            idle = self.radix.evictable_blocks()
            if need > idle:
                unpin()
                raise PoolExhausted(
                    f"need {n_new} blocks, {self.pool.free_count()} free + "
                    f"{idle} evictable (pool of {self.pool.n_blocks})")
            self.metrics.blocks_evicted += self.radix.evict(need)
        try:
            fresh = self.pool.alloc(n_new)
        except PoolExhausted:
            unpin()
            raise
        blocks = shared + fresh
        n_reused = len(shared) * bs
        cow = None
        if cow_src is not None:
            cow = (cow_src, fresh[0])
            n_reused += partial[1]
            self.metrics.cow_copies += 1
        if n_reused:
            self.metrics.hits += 1
        else:
            self.metrics.misses += 1
        self.metrics.tokens_reused += n_reused
        self.metrics.tokens_computed += max(len(prompt) - n_reused, 0)
        return Admission(blocks=blocks, n_reused=n_reused, cow=cow,
                         fresh=fresh)

    def cow_done(self, src: int):
        """The engine finished copying pool row `src`; drop the pin."""
        self.pool.decref([src])

    # ------------------------------------------------------------ lifecycle
    def commit(self, tokens, blocks: List[int]):
        """Index the blocks fully covered by `tokens` in the radix tree so
        future prompts sharing the prefix reuse them. Safe to call with a
        chain longer than the token run — only full chunks are stored."""
        n_full = len(tokens) // self.pool.block_size
        if n_full:
            self.metrics.inserts += self.radix.insert(tokens, blocks[:n_full])

    def release(self, blocks: List[int]):
        """Request done: return its references. Blocks also indexed by the
        radix tree survive (refcount held by the tree) — that is the cache."""
        self.pool.decref(blocks)

    def rollback(self, blocks: List[int], n_valid: int, n_written: int,
                 *, shared=None):
        """Speculative decode rejected written tokens: positions
        [n_valid, n_written) of the chain hold KV that must never be
        attended again. The paged layout makes this O(1) device-side — the
        frontier rewind alone hides the stale rows (every read masks
        ``kv_pos <= pos``) — so rollback here is the *safety half* of the
        contract: the trimmed page range must be exclusively owned by the
        rolling-back request. A radix-indexed (shared) page in that range
        means unverified tokens were committed, or a CoW clone was skipped —
        either way another chain would silently attend garbage, so raise
        instead of corrupting the cache. Returns the trimmed page ids.

        `shared` lets a caller rolling back many slots in one dispatch
        precompute set(radix.all_blocks()) once instead of paying the
        O(tree) walk per slot (the engine's _step_spec does).
        """
        if not 0 <= n_valid <= n_written:
            raise ValueError(f"rollback range [{n_valid}, {n_written})")
        bs = self.pool.block_size
        first = n_valid // bs                   # page holding 1st stale row
        last = min(-(-n_written // bs), len(blocks))
        dirty = blocks[first:last]
        if dirty:
            if shared is None:
                shared = set(self.radix.all_blocks())
            for b in dirty:
                if b == self.pool.NULL_BLOCK:   # overflow writes land here
                    continue
                if b in shared:
                    raise ValueError(
                        f"rollback would trim radix-shared block {b} "
                        f"(speculative tokens must never be committed)")
                if self.pool.ref(b) < 1:
                    raise ValueError(f"rollback of freed block {b}")
        self.metrics.rollbacks += 1
        self.metrics.tokens_rolled_back += n_written - n_valid
        return dirty

    def free_tokens(self) -> int:
        """Token capacity available without displacing a running request:
        free blocks plus cached chains eviction can actually reclaim
        (exact — ``RadixTree.evictable_blocks`` walks chain tails, so an
        idle block pinned under an in-use descendant is not counted)."""
        return (self.pool.free_count()
                + self.radix.evictable_blocks()) * self.pool.block_size

    # ------------------------------------------------------------- queries
    def occupancy(self) -> int:
        """Blocks currently held (allocated, incl. radix-pinned) — the
        utilization ledger integrates this per step as pool-block-seconds,
        turning point-in-time occupancy into a cost over time."""
        return self.pool.allocated_count()

    def match_len(self, prompt) -> int:
        """Cached-prefix probe (tokens), without touching LRU recency —
        the gateway's prefix-affinity policy calls this on every replica."""
        return self.radix.match_len(prompt, peek=True)

    def check_invariants(self):
        self.pool.check_invariants()
        for b in self.radix.all_blocks():
            assert self.pool.ref(b) >= 1, f"tree references freed block {b}"
