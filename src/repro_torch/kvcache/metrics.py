"""KV-cache counters: the hit/miss/eviction telemetry behind the paged path.

One `CacheMetrics` per engine replica. `tokens_reused` vs `tokens_computed`
is the headline pair: dense prefill always computes the full prompt, so
``reuse_frac`` is exactly the fraction of prompt tokens the paged path did
NOT have to run through the model. Rendered by
`core.reporting.kvcache_summary_table` and folded into the gateway
dashboard.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class CacheMetrics:
    hits: int = 0               # admissions that reused >= 1 cached token
    misses: int = 0             # admissions with no reusable prefix
    tokens_reused: int = 0      # prompt tokens served from cached KV
    tokens_computed: int = 0    # prompt tokens actually prefilled
    blocks_evicted: int = 0     # pool blocks reclaimed from the radix tree
    cow_copies: int = 0         # partial-block reuses (copy-on-write clones)
    inserts: int = 0            # blocks newly indexed by the radix tree
    rollbacks: int = 0          # speculative-decode rejections rolled back
    tokens_rolled_back: int = 0 # written-then-rejected draft tokens

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    @property
    def reuse_frac(self) -> float:
        total = self.tokens_reused + self.tokens_computed
        return self.tokens_reused / total if total else 0.0

    def as_dict(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "tokens_reused": self.tokens_reused,
            "tokens_computed": self.tokens_computed,
            "reuse_frac": self.reuse_frac,
            "blocks_evicted": self.blocks_evicted,
            "cow_copies": self.cow_copies,
            "inserts": self.inserts,
            "rollbacks": self.rollbacks,
            "tokens_rolled_back": self.tokens_rolled_back,
        }

    def merge(self, other: "CacheMetrics") -> "CacheMetrics":
        """Aggregate across replicas (gateway dashboard)."""
        return CacheMetrics(
            hits=self.hits + other.hits,
            misses=self.misses + other.misses,
            tokens_reused=self.tokens_reused + other.tokens_reused,
            tokens_computed=self.tokens_computed + other.tokens_computed,
            blocks_evicted=self.blocks_evicted + other.blocks_evicted,
            cow_copies=self.cow_copies + other.cow_copies,
            inserts=self.inserts + other.inserts,
            rollbacks=self.rollbacks + other.rollbacks,
            tokens_rolled_back=self.tokens_rolled_back
            + other.tokens_rolled_back,
        )
