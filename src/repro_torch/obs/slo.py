"""Per-tenant / per-tier SLO tracking over the gateway's request stream.

An `SLOSpec` names the latency targets a priority tier is sold under
(TTFT, per-request ITL p95, worst stall, end-to-end deadline). An
`SLOTracker` attaches to `GatewayMetrics.observers` and judges every
request the moment it reaches a terminal state — no polling, no second
bookkeeping pass — accumulating per-tier and per-tenant attainment,
goodput (tokens from SLO-met requests only), and shed/429 counts split
by cause. `report()` is the `reporting.slo_dashboard` / bench-harness
payload; the tracker also registers as the "slo" scope of the gateway's
`MetricsRegistry`, so `Gateway.snapshot()` carries it.

The SLO judgment is per-request and online, which is what makes it
usable as a flight-recorder trigger: the breach fires while the span
ring buffer still holds the evidence.
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import TYPE_CHECKING, Dict, List, Optional

if TYPE_CHECKING:   # duck-typed at runtime: obs must not import gateway
    from repro_torch.gateway.metrics import RequestMetrics

now = time.perf_counter


@dataclass(frozen=True)
class SLOSpec:
    """Latency targets for one tier. None disables that target (a batch
    tier typically only cares about completion)."""
    name: str
    ttft_ms: Optional[float] = None       # submit -> first token
    itl_p95_ms: Optional[float] = None    # per-request inter-token p95
    stall_ms: Optional[float] = None      # per-request worst token gap
    deadline_ms: Optional[float] = None   # submit -> finish

    def violations(self, m: RequestMetrics) -> List[str]:
        """Which targets a finished request blew, by field name."""
        out = []
        if self.ttft_ms is not None and (
                m.ttft is None or m.ttft * 1e3 > self.ttft_ms):
            out.append("ttft_ms")
        if self.itl_p95_ms is not None and (
                m.itl_p95 is not None and m.itl_p95 * 1e3 > self.itl_p95_ms):
            out.append("itl_p95_ms")
        if self.stall_ms is not None and (
                m.itl_max is not None and m.itl_max * 1e3 > self.stall_ms):
            out.append("stall_ms")
        if self.deadline_ms is not None and (
                m.finish_t is None or m.submit_t is None
                or (m.finish_t - m.submit_t) * 1e3 > self.deadline_ms):
            out.append("deadline_ms")
        return out


# what `--slo default` means: a premium interactive tier with tight
# first-token/stall targets, a standard API tier with looser ones, and a
# batch tier judged on completion only
DEFAULT_TIER_SLOS: Dict[int, SLOSpec] = {
    0: SLOSpec("interactive", ttft_ms=2_000.0, itl_p95_ms=500.0,
               stall_ms=1_500.0),
    1: SLOSpec("standard", ttft_ms=5_000.0, itl_p95_ms=1_000.0,
               stall_ms=3_000.0),
    2: SLOSpec("batch"),
}


def load_slos(path) -> Dict[int, SLOSpec]:
    """Read a tier->SLOSpec mapping from JSON:
    `{"0": {"name": "interactive", "ttft_ms": 2000, ...}, ...}`."""
    with open(path) as f:
        doc = json.load(f)
    out = {}
    for tier, spec in doc.items():
        out[int(tier)] = SLOSpec(
            name=str(spec.get("name", f"tier{tier}")),
            ttft_ms=spec.get("ttft_ms"), itl_p95_ms=spec.get("itl_p95_ms"),
            stall_ms=spec.get("stall_ms"), deadline_ms=spec.get("deadline_ms"))
    return out


def save_slos(path, tiers: Dict[int, SLOSpec]) -> Path:
    path = Path(path)
    with open(path, "w") as f:
        json.dump({str(k): asdict(v) for k, v in sorted(tiers.items())},
                  f, indent=2)
        f.write("\n")
    return path


class _TierStats:
    __slots__ = ("finished", "met", "breached", "breaches_by_target",
                 "shed_deadline", "shed_capacity", "shed_brownout", "failed",
                 "tokens", "tokens_met")

    def __init__(self):
        self.finished = 0
        self.met = 0
        self.breached = 0
        self.breaches_by_target: Dict[str, int] = {}
        self.shed_deadline = 0      # deadline-based shedding
        self.shed_capacity = 0      # admission-control 429s
        self.shed_brownout = 0      # graceful-degradation 503s
        self.failed = 0
        self.tokens = 0
        self.tokens_met = 0         # tokens from SLO-met requests = goodput

    def as_dict(self) -> dict:
        submitted = (self.finished + self.shed_deadline + self.shed_capacity
                     + self.shed_brownout + self.failed)
        return {
            "submitted": submitted,
            "finished": self.finished,
            "met": self.met,
            "breached": self.breached,
            "attainment": (self.met / self.finished
                           if self.finished else None),
            "breaches_by_target": dict(self.breaches_by_target),
            "shed_deadline": self.shed_deadline,
            "shed_capacity_429": self.shed_capacity,
            "shed_brownout_503": self.shed_brownout,
            "failed": self.failed,
            "tokens": self.tokens,
            "tokens_met": self.tokens_met,
        }


class SLOTracker:
    """Judges each terminal request against its tier's SLOSpec.

    Attainment is met/finished; shed and failed requests are counted
    separately rather than folded into attainment, because "we 429'd it
    in 2ms" and "we served it late" are different failures with different
    fixes (capacity vs scheduling). Untiered specs fall back to
    `default_spec` (judge everything as met unless targets are set).
    """

    def __init__(self, tiers: Optional[Dict[int, SLOSpec]] = None, *,
                 default_spec: Optional[SLOSpec] = None):
        self.tiers = dict(tiers if tiers is not None else DEFAULT_TIER_SLOS)
        self.default_spec = default_spec or SLOSpec("default")
        self._per_tier: Dict[int, _TierStats] = {}
        self._per_tenant: Dict[str, _TierStats] = {}
        self._tenant_tier: Dict[str, int] = {}
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        # most recent judgments, newest last: (request_id, tier, tenant,
        # violations) — the flight recorder trigger reads the tail
        self.last_breach: Optional[dict] = None

    def spec_for(self, tier: int) -> SLOSpec:
        return self.tiers.get(tier, self.default_spec)

    def _stats(self, m: RequestMetrics):
        tier = self._per_tier.setdefault(m.tier, _TierStats())
        if m.tenant is None:
            return (tier,)
        self._tenant_tier.setdefault(m.tenant, m.tier)
        return (tier, self._per_tenant.setdefault(m.tenant, _TierStats()))

    # ------------------------------------------------- lifecycle observer
    def lifecycle(self, kind: str, m: RequestMetrics):
        if kind == "submit":
            if self._t0 is None:
                self._t0 = m.submit_t
            return
        if kind == "finish":
            self._t_last = m.finish_t
            spec = self.spec_for(m.tier)
            violations = spec.violations(m)
            for s in self._stats(m):
                s.finished += 1
                s.tokens += m.n_tokens
                if violations:
                    s.breached += 1
                    for v in violations:
                        s.breaches_by_target[v] = \
                            s.breaches_by_target.get(v, 0) + 1
                else:
                    s.met += 1
                    s.tokens_met += m.n_tokens
            if violations:
                self.last_breach = {
                    "request_id": m.request_id, "tier": m.tier,
                    "tenant": m.tenant, "violations": violations,
                    "spec": spec.name}
        elif kind == "reject":
            self._t_last = m.finish_t
            for s in self._stats(m):
                if m.status == "failed":
                    s.failed += 1
                elif m.finish_reason == "over_capacity":
                    s.shed_capacity += 1
                elif m.finish_reason == "brownout":
                    # shed by the graceful-degradation ladder, not by
                    # deadline: a capacity decision the operator made, so
                    # it must not read as a latency failure
                    s.shed_brownout += 1
                else:               # deadline expiry and queue aborts
                    s.shed_deadline += 1

    # ---------------------------------------------------------- reduction
    def report(self) -> dict:
        """The slo_dashboard payload: per-tier rows (sorted, premium
        first), per-tenant rows, and an overall roll-up with goodput
        (tokens of SLO-met requests per second of tracked wall time)."""
        t_end = self._t_last if self._t_last is not None else now()
        duration = (t_end - self._t0) if self._t0 is not None else 0.0
        tiers = {}
        for tier in sorted(self._per_tier):
            d = self._per_tier[tier].as_dict()
            d["spec"] = self.spec_for(tier).name
            d["goodput_tok_s"] = (d["tokens_met"] / duration
                                  if duration > 0 else 0.0)
            tiers[tier] = d
        tenants = {}
        for name in sorted(self._per_tenant):
            d = self._per_tenant[name].as_dict()
            d["tier"] = self._tenant_tier.get(name, 0)
            tenants[name] = d
        overall = _TierStats()
        for s in self._per_tier.values():
            for f in _TierStats.__slots__:
                if f != "breaches_by_target":
                    setattr(overall, f, getattr(overall, f) + getattr(s, f))
            for k, v in s.breaches_by_target.items():
                overall.breaches_by_target[k] = \
                    overall.breaches_by_target.get(k, 0) + v
        out = overall.as_dict()
        out["goodput_tok_s"] = (out["tokens_met"] / duration
                                if duration > 0 else 0.0)
        out["duration_s"] = duration
        return {"overall": out, "tiers": tiers, "tenants": tenants}
