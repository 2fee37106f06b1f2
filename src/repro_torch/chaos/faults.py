"""Fault plans: seeded, deterministic schedules of serving-stack faults.

A `FaultSpec` names ONE fault and exactly when it fires, in one of two
deterministic clocks:

  * ``at_step``     — the gateway step counter (one `Gateway.step()` call
                      advances it by one), for fleet-level faults.
  * ``at_dispatch`` — the target replica's engine-dispatch counter (one
                      `ServeEngine.step()` call advances it by one), for
                      replica-local faults.

Both clocks are counted by the injector from the moment it arms, so the
same plan against the same workload reproduces the same run bit-for-bit
— chaos you can put in CI, not chaos-monkey roulette.

Kinds:

  * ``crash``            — raise `ChaosReplicaCrash` inside the replica's
                           `ServeEngine.step` at dispatch `at_dispatch`.
  * ``straggler``        — sleep `delay_s` before every dispatch in
                           [`at_dispatch`, `until`) on the target replica.
  * ``pool_pressure``    — allocate and hold `blocks` KV pool blocks on
                           the target (paged) replica over gateway steps
                           [`at_step`, `until`), forcing `PoolExhausted`
                           pressure on admission.
  * ``nan_logits``       — corrupt the logits row of the target replica's
                           `at_dispatch`-th host-side sampling call to
                           all-NaN (exercises the request-scoped failure
                           path; the greedy in-jit argmax never samples
                           host-side, so aim this at a sampled request).
  * ``lease_expiry``     — at gateway step `at_step`, force every lease
                           the queue currently holds to expire (the
                           redelivery path must not double-place).
  * ``journal_truncate`` — not armed against a live gateway: a reload-
                           time fault applied by
                           `FaultInjector.truncate_journal` (torn tail).

The plan's `seed` fills in anything a spec leaves unset (today: the
target replica), so a plan is fully deterministic even when partially
specified.
"""
from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from typing import List, Optional

FAULT_KINDS = ("crash", "straggler", "pool_pressure", "nan_logits",
               "lease_expiry", "journal_truncate")


@dataclass(frozen=True)
class FaultSpec:
    kind: str
    replica: Optional[int] = None       # target replica id (None: rng picks)
    at_step: Optional[int] = None       # gateway-step clock (0-based)
    at_dispatch: Optional[int] = None   # replica-dispatch clock (0-based)
    until: Optional[int] = None         # window end (exclusive), same clock
    delay_s: float = 0.0                # straggler per-dispatch sleep
    blocks: int = 0                     # pool_pressure blocks held

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        clock = {"crash": "at_dispatch", "straggler": "at_dispatch",
                 "nan_logits": "at_dispatch", "pool_pressure": "at_step",
                 "lease_expiry": "at_step"}.get(self.kind)
        if clock is not None and getattr(self, clock) is None:
            raise ValueError(f"{self.kind} needs {clock}")
        if self.kind in ("straggler", "pool_pressure") and self.until is None:
            raise ValueError(f"{self.kind} needs an `until` window end")


@dataclass
class FaultPlan:
    """A seeded schedule of faults; the unit `FaultInjector` arms."""
    seed: int = 0
    faults: List[FaultSpec] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "faults": [asdict(f) for f in self.faults]})

    @classmethod
    def from_json(cls, doc: str) -> "FaultPlan":
        d = json.loads(doc)
        return cls(seed=int(d.get("seed", 0)),
                   faults=[FaultSpec(**f) for f in d.get("faults", [])])


# ------------------------------------------------------------- compact DSL

_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@(?P<clock>[ds])(?P<start>\d+)(?:-(?P<end>\d+))?"
    r"(?P<args>(?::[^:,]+)*)$")

_KIND_ALIASES = {"pool": "pool_pressure", "nan": "nan_logits",
                 "expire": "lease_expiry", "slow": "straggler"}


def parse_plan(text: str, seed: int = 0) -> FaultPlan:
    """Parse the launcher's compact plan syntax: comma-separated
    ``kind@<clock><start>[-<end>][:rN][:ARG]`` specs where the clock is
    ``d`` (replica dispatch index) or ``s`` (gateway step index).

      crash@d6:r0              crash replica 0 at its 6th dispatch
      straggler@d4-12:r1:2ms   2 ms sleep on replica 1's dispatches 4..11
      pool@s8-40:r0:4          hold 4 pool blocks over gateway steps 8..39
      nan@d3:r0                NaN the 3rd sampling call on replica 0
      expire@s10               force-expire every lease at gateway step 10
    """
    faults = []
    for part in filter(None, (p.strip() for p in text.split(","))):
        m = _SPEC_RE.match(part)
        if m is None:
            raise ValueError(f"bad fault spec {part!r} (expected "
                             f"kind@[ds]N[-M][:rK][:ARG])")
        kind = _KIND_ALIASES.get(m["kind"], m["kind"])
        start, end = int(m["start"]), m["end"] and int(m["end"])
        kw = {"kind": kind, "until": end}
        kw["at_dispatch" if m["clock"] == "d" else "at_step"] = start
        for arg in filter(None, m["args"].split(":")):
            if re.fullmatch(r"r\d+", arg):
                kw["replica"] = int(arg[1:])
            elif arg.endswith("ms"):
                kw["delay_s"] = float(arg[:-2]) / 1e3
            elif arg.endswith("s"):
                kw["delay_s"] = float(arg[:-1])
            else:
                kw["blocks"] = int(arg)
        faults.append(FaultSpec(**kw))
    return FaultPlan(seed=seed, faults=faults)


def resolve_targets(plan: FaultPlan, n_replicas: int) -> List[FaultSpec]:
    """Pin every spec's target replica, drawing unspecified ones from the
    plan's seeded rng — the step that makes a partial plan deterministic."""
    import numpy as np
    rng = np.random.default_rng(plan.seed)
    out = []
    for f in plan.faults:
        if f.replica is None and f.kind != "lease_expiry":
            f = FaultSpec(**{**asdict(f),
                             "replica": int(rng.integers(n_replicas))})
        out.append(f)
    return out
