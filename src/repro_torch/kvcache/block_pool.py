"""Fixed-size KV block pool: refcounted page allocator for the paged cache.

The pool is pure bookkeeping — it hands out integer block ids; the actual
KV tensors live in the engine's device-side pool arrays (one row per block
id in every attention layer, see ``models/transformer.init_paged_cache``).
A block holds ``block_size`` tokens worth of K/V for *every* layer at once,
so one id is enough to name a page across the whole stack (the vLLM block
table convention).

Block 0 is reserved as the *null block*: inactive slots and padded prefill
positions scatter their garbage writes there, so the jitted decode never
needs a branch on "is this slot live". It is never allocated and never
freed.

Refcounts implement sharing: a radix-tree prefix chain and every request
whose block table references a block each hold one reference. ``decref``
returns a block to the free list only at zero; going below zero (double
free) raises — the property tests lean on this.
"""
from __future__ import annotations

from typing import Iterable, List


class PoolExhausted(RuntimeError):
    """Not enough free blocks to satisfy an allocation."""


class BlockPool:
    NULL_BLOCK = 0

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (block 0 is reserved)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # LIFO free list → recently-freed (cache-warm) blocks are reused
        # first; block 0 is reserved and never enters the list
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._ref = [0] * n_blocks

    # ------------------------------------------------------------- queries
    def free_count(self) -> int:
        return len(self._free)

    def allocated_count(self) -> int:
        """Blocks currently held (excludes the reserved null block)."""
        return (self.n_blocks - 1) - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def ref(self, block_id: int) -> int:
        return self._ref[block_id]

    # ------------------------------------------------------------ lifecycle
    def alloc(self, n: int) -> List[int]:
        """Hand out `n` blocks with refcount 1 each. All-or-nothing: raises
        PoolExhausted (allocating nothing) when fewer than `n` are free."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free "
                f"(pool of {self.n_blocks})")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, block_ids: Iterable[int]) -> None:
        for b in block_ids:
            if b == self.NULL_BLOCK:
                raise ValueError("cannot take a reference on the null block")
            if self._ref[b] <= 0:
                raise ValueError(f"incref on free block {b}")
            self._ref[b] += 1

    def decref(self, block_ids: Iterable[int]) -> List[int]:
        """Release one reference per id; returns the ids that dropped to
        zero and went back on the free list. Double-free raises."""
        freed = []
        for b in block_ids:
            if b == self.NULL_BLOCK:
                raise ValueError("cannot release the null block")
            if self._ref[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
                freed.append(b)
        return freed

    def check_invariants(self) -> None:
        """free list + live refcounts must exactly partition the pool."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate entries in free list"
        assert self.NULL_BLOCK not in free
        for b in range(1, self.n_blocks):
            held = self._ref[b] > 0
            assert held != (b in free), (
                f"block {b}: ref={self._ref[b]}, in_free={b in free}")
