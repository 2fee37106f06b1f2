"""Observability subsystem: tracing, metrics, workloads, SLOs, post-mortems.
The port's copy of `repro.obs` (only `trace.fence` differs: see there).

`trace` records named wall-clock spans along the request path (gateway
submit -> dispatch -> engine step -> jit dispatch -> retire) into a ring
buffer and exports Chrome trace events loadable in Perfetto; disabled by
default and near-free when off. `registry` unifies the per-silo metric
counters (gateway, kvcache, speculation, scheduler) behind one
`MetricsRegistry` whose `snapshot()` is the single serving-telemetry
dict — see `Gateway.snapshot()` and `core.reporting.unified_dashboard`.

On top of those instruments sit the production-shaped pieces: `workload`
generates/replays seeded multi-tenant traces (heavy-tailed lengths,
diurnal bursts, priority tiers), `slo` judges every request against its
tier's latency targets live, and `flight` is the anomaly flight recorder
that dumps the evidence rings to a Perfetto file when an SLO breach,
illegal lifecycle transition, replica failure, or shed spike fires.

The continuous-telemetry layer turns those point-in-time instruments
into series and exposition: `timeseries` runs the sampler thread pulling
`snapshot()` into ring-buffered series with windowed aggregates,
`export` renders OpenMetrics text (with a strict in-repo parser) and
serves it from a stdlib-HTTP endpoint, and `ledger` attributes each
engine dispatch's measured device time across tenants by token share.
"""
from repro_torch.obs import trace
from repro_torch.obs import workload
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, DEFAULT_BUCKETS)
from repro_torch.obs.slo import (DEFAULT_TIER_SLOS, SLOSpec, SLOTracker,
                                 load_slos, save_slos)
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.timeseries import TimeSeriesSampler, flatten_numeric
from repro_torch.obs.export import (MetricsServer, OpenMetricsParseError,
                                    openmetrics_text, parse_openmetrics)
from repro_torch.obs.ledger import UtilizationLedger

__all__ = ["Counter", "DEFAULT_BUCKETS", "DEFAULT_TIER_SLOS",
           "FlightRecorder", "Gauge", "Histogram", "MetricsRegistry",
           "MetricsServer", "OpenMetricsParseError", "SLOSpec", "SLOTracker",
           "TimeSeriesSampler", "UtilizationLedger", "flatten_numeric",
           "load_slos", "openmetrics_text", "parse_openmetrics", "save_slos",
           "trace", "workload"]
