"""Radix-tree prefix index: token prefixes -> KV block chains.

The tree is keyed over *block-size token chunks*, not single tokens: one
edge symbol = one full KV page, so every node stores a run of chunks with
the parallel list of pool block ids that hold their prefilled KV. Matching
a new prompt against the tree yields the longest previously-prefilled
prefix at block granularity, plus (optionally) a *partial* tail — the next
chunk's first ``j`` tokens also match, which the engine exploits by
copy-on-write-cloning that block and reusing ``j`` of its rows.

The tree owns one pool reference per stored block (taken on insert,
released on evict), so a chain stays resident after the request that
prefilled it retires — that is the whole point: the next request with the
same prefix skips prefill for the matched tokens. Under pool pressure the
engine calls ``evict`` which trims least-recently-matched chains whose
blocks nobody else references (refcount 1 = tree-only), tail-first so a
chain shared mid-way with a running request keeps its live prefix.

Recency is a logical clock (monotone counter), not wall time, so behavior
is deterministic under test.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.kvcache.block_pool import BlockPool


def _common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class _Node:
    __slots__ = ("chunks", "blocks", "children", "parent", "last_access")

    def __init__(self, chunks, blocks, parent):
        self.chunks: List[tuple] = chunks      # run of block_size-token keys
        self.blocks: List[int] = blocks        # parallel pool block ids
        self.children: Dict[tuple, "_Node"] = {}
        self.parent: Optional["_Node"] = parent
        self.last_access = 0

    def is_leaf(self) -> bool:
        return not self.children


class RadixTree:
    def __init__(self, block_size: int, pool: BlockPool):
        self.block_size = block_size
        self.pool = pool
        self.root = _Node([], [], None)
        self._clock = 0

    # -------------------------------------------------------------- helpers
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _touch(self, node: _Node):
        t = self._tick()
        while node is not None:
            node.last_access = t
            node = node.parent

    def _chunks_of(self, tokens) -> Tuple[List[tuple], List[int]]:
        bs = self.block_size
        n_full = len(tokens) // bs
        chunks = [tuple(tokens[i * bs:(i + 1) * bs]) for i in range(n_full)]
        return chunks, list(tokens[n_full * bs:])

    # ---------------------------------------------------------------- match
    def match(self, tokens, *, peek: bool = False
              ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest cached prefix of `tokens`.

        Returns (full_blocks, partial): `full_blocks` are pool ids whose
        pages are entirely covered by the prompt (block-aligned reuse, no
        copy needed); `partial` is ``(block_id, j)`` when the next cached
        block agrees with the prompt on its first j (< block_size) tokens —
        reusable only via copy-on-write. ``peek`` skips the LRU touch (used
        by the gateway's routing probe, which must not distort recency).
        """
        chunks, leftover = self._chunks_of(tokens)
        node, ci, out = self.root, 0, []
        partial = None
        while True:
            nxt = chunks[ci] if ci < len(chunks) else None
            child = node.children.get(nxt) if nxt is not None else None
            if child is None:
                # no full-chunk edge: look for a within-block partial match
                rem = list(nxt) if nxt is not None else leftover
                if rem:
                    best_j, best_c = 0, None
                    for key, c in node.children.items():
                        j = _common_prefix(rem, key)
                        if j > best_j:
                            best_j, best_c = j, c
                    if best_j:
                        partial = (best_c.blocks[0], best_j)
                        if not peek:
                            self._touch(best_c)
                break
            stop = False
            for k in range(len(child.chunks)):
                if ci < len(chunks) and chunks[ci] == child.chunks[k]:
                    out.append(child.blocks[k])
                    ci += 1
                else:
                    rem = (list(chunks[ci]) if ci < len(chunks) else leftover)
                    j = _common_prefix(rem, child.chunks[k])
                    if j:
                        partial = (child.blocks[k], j)
                    stop = True
                    break
            if not peek:
                self._touch(child)
            if stop:
                break
            node = child
        return out, partial

    def match_len(self, tokens, *, peek: bool = True) -> int:
        """Reusable prefix length in tokens (full blocks + CoW partial)."""
        blocks, partial = self.match(tokens, peek=peek)
        return len(blocks) * self.block_size + (partial[1] if partial else 0)

    # --------------------------------------------------------------- insert
    def insert(self, tokens, blocks: List[int]) -> int:
        """Index `tokens`' full-block chunks under the given pool blocks
        (parallel, one per chunk). Chunks already present are deduplicated —
        the existing block stays canonical and the caller's duplicate id is
        NOT referenced. Newly stored blocks get one pool ref each. Returns
        the number of blocks newly referenced by the tree."""
        chunks, _ = self._chunks_of(tokens)
        chunks = chunks[:len(blocks)]
        blocks = blocks[:len(chunks)]
        node, ci, added = self.root, 0, 0
        while ci < len(chunks):
            child = node.children.get(chunks[ci])
            if child is None:
                new = _Node(chunks[ci:], blocks[ci:], node)
                self.pool.incref(new.blocks)
                added += len(new.blocks)
                node.children[new.chunks[0]] = new
                self._touch(new)
                return added
            k = 0
            while (k < len(child.chunks) and ci < len(chunks)
                   and child.chunks[k] == chunks[ci]):
                k += 1
                ci += 1
            if k < len(child.chunks):
                if ci == len(chunks):       # ends inside this node: all dup
                    self._touch(child)
                    return added
                # diverges inside this node: split at chunk k
                tail = _Node(child.chunks[k:], child.blocks[k:], child)
                tail.children = child.children
                for gc in tail.children.values():
                    gc.parent = tail
                tail.last_access = child.last_access
                child.chunks, child.blocks = child.chunks[:k], child.blocks[:k]
                child.children = {tail.chunks[0]: tail}
                # loop continues: child now has no edge for chunks[ci]
            node = child
        self._touch(node)
        return added

    # ---------------------------------------------------------------- evict
    def _evictable_tail(self, node: _Node) -> int:
        """Length of the longest tail of `node.blocks` held only by the
        tree (pool refcount 1) — safe to free without breaking a running
        request or an ancestor chain."""
        k = len(node.blocks)
        while k > 0 and self.pool.ref(node.blocks[k - 1]) == 1:
            k -= 1
        return len(node.blocks) - k

    def evict(self, n_blocks: int) -> int:
        """Free up to `n_blocks` pool blocks, least-recently-matched chain
        tails first. Returns how many were actually freed."""
        freed = 0
        while freed < n_blocks:
            victims = [n for n in self._leaves()
                       if self._evictable_tail(n) > 0]
            if not victims:
                break
            node = min(victims, key=lambda n: n.last_access)
            tail = self._evictable_tail(node)
            take = min(tail, n_blocks - freed)
            cut = len(node.blocks) - take
            self.pool.decref(node.blocks[cut:])
            freed += take
            node.chunks, node.blocks = node.chunks[:cut], node.blocks[:cut]
            if not node.blocks and node.is_leaf() and node.parent is not None:
                del node.parent.children[next(
                    k for k, v in node.parent.children.items() if v is node)]
        return freed

    def evictable_blocks(self) -> int:
        """Exactly how many tree blocks ``evict`` could free right now.

        Not the same as "blocks with refcount 1": eviction only trims chain
        *tails* (a block frees only after every block deeper in its chain —
        later in its node, and in every descendant node — is freed), so an
        idle inner block pinned under an in-use descendant is unreachable.
        Counting those would over-report free capacity and let admission
        over-commit (the gateway's token-budget check consumes this number).
        """
        def walk(node: _Node):
            # (evictable blocks in subtree, subtree fully evictable?)
            total, descendants_clear = 0, True
            for child in node.children.values():
                t, f = walk(child)
                total += t
                descendants_clear &= f
            if not descendants_clear:
                return total, False
            tail = self._evictable_tail(node)
            return total + tail, tail == len(node.blocks)

        return walk(self.root)[0]

    # ----------------------------------------------------------------- info
    def _leaves(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root and n.is_leaf():
                out.append(n)
            stack.extend(n.children.values())
        return out

    def n_blocks(self) -> int:
        """Total pool blocks currently referenced by the tree."""
        total, stack = 0, [self.root]
        while stack:
            n = stack.pop()
            total += len(n.blocks)
            stack.extend(n.children.values())
        return total

    def all_blocks(self) -> List[int]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            out.extend(n.blocks)
            stack.extend(n.children.values())
        return out
