"""Per-request sampling, re-exported at the gateway tier.

The implementation lives in `repro_torch.serve.sampler` so the serve
engine (a lower tier) can use it without importing the gateway package —
importing it from either path yields the same objects.
"""
from repro_torch.serve.sampler import (  # noqa: F401
    GREEDY, Sampler, SamplingParams, apply_top_k, apply_top_p, sample_token)

__all__ = ["GREEDY", "Sampler", "SamplingParams", "apply_top_k",
           "apply_top_p", "sample_token"]
