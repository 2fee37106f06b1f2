"""Serving gateway: queue-backed routing, sampling, streaming, telemetry."""
from repro_torch.gateway.gateway import (  # noqa: F401
    POLICIES, BrownoutConfig, BrownoutController, DispatchPolicy,
    EngineReplica, Gateway, GatewayRequest, LeastLoaded, PrefixAffinity,
    RoundRobin)
from repro_torch.gateway.metrics import (  # noqa: F401
    GatewayMetrics, RequestMetrics)
from repro_torch.gateway.sampler import (GREEDY, Sampler,  # noqa: F401
                                         SamplingParams, sample_token)
from repro_torch.gateway.streaming import TokenStream  # noqa: F401
