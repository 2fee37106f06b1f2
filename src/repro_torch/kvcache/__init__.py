"""Paged KV-cache subsystem: block pool + radix prefix index + metrics.

See `manager.KVCacheManager` for the engine-facing API and
`serve/engine.py` (kv_layout="paged") for the end-to-end integration.
"""
from repro_torch.kvcache.block_pool import BlockPool, PoolExhausted
from repro_torch.kvcache.manager import Admission, KVCacheManager
from repro_torch.kvcache.metrics import CacheMetrics
from repro_torch.kvcache.radix import RadixTree

__all__ = ["Admission", "BlockPool", "CacheMetrics", "KVCacheManager",
           "PoolExhausted", "RadixTree"]
