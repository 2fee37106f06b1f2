"""Deterministic concurrency test harness + lock/race assertion layer.

Two artifacts the async-worker migration ships with (and every later
threaded subsystem can reuse):

  * `harness.StepBarrierScheduler` — a seeded cooperative scheduler that
    serializes participant threads at explicit checkpoints and picks the
    next runner with a seeded RNG, so an adversarial interleaving is a
    *seed*: replayable, shrinkable, assertable.
  * `locks.LockOrderAuditor` / `locks.ExclusiveRegion` — lightweight
    runtime assertions for the locking discipline the gateway's worker
    threads rely on: a global lock-acquisition-order graph that flags
    cycles (potential deadlocks) the moment a test constructs one, and a
    single-owner region check (e.g. "only its own worker ever steps an
    engine").

Production code never imports this package; the gateway's worker gate is
a plain optional callback the tests bind to a scheduler.
"""
from repro_torch.concurrency.harness import (  # noqa: F401
    ScheduleStall, StepBarrierScheduler)
from repro_torch.concurrency.locks import (  # noqa: F401
    AuditedLock, ExclusiveRegion, LockOrderAuditor, LockOrderError,
    audit_serving_stack)
