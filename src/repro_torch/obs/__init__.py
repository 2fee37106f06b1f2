"""Observability for the port: the span tracer and the step-time
histogram (copies of `repro.obs.trace` and `repro.obs.registry.Histogram`).
"""
from repro_torch.obs import trace
from repro_torch.obs.registry import DEFAULT_BUCKETS, Histogram

__all__ = ["DEFAULT_BUCKETS", "Histogram", "trace"]
