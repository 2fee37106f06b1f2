"""Lock-order and race assertions for the threaded serving stack.

The gateway's locking discipline is a strict hierarchy — the gateway
lock is taken first, and the queue / metrics / registry / tracer /
stream locks are leaves acquired under it (never the reverse). That
discipline is what makes the worker threads deadlock-free, and this
module is how the tests *check* it instead of trusting a comment:

  * `LockOrderAuditor.wrap(name, lock)` returns an `AuditedLock` that
    records, per thread, which named locks are held at every acquire and
    adds edges to a global acquisition-order graph. An acquire that
    closes a cycle in that graph (lock A taken under B somewhere, B
    under A elsewhere) is a potential deadlock even if this run never
    interleaved into it — recorded (or raised, with ``strict=True``) at
    the moment the order is violated.
  * `ExclusiveRegion` asserts single-ownership: at most one thread inside
    at a time (e.g. each engine is only ever stepped by its own worker).
  * `audit_serving_stack(gw)` re-wraps a Gateway's whole lock hierarchy
    in place (gateway lock + conditions, queue, metrics, registry,
    tracer) so a stress test runs with the auditor armed and ends with
    ``auditor.assert_clean()``.

AuditedLock implements the `threading.Condition` owner protocol
(`_release_save` / `_acquire_restore` / `_is_owned`) by delegation, so
conditions built on a wrapped RLock keep working.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

from repro_torch.obs import trace as otrace


class LockOrderError(AssertionError):
    """A lock acquisition closed a cycle in the acquisition-order graph."""


class LockOrderAuditor:
    def __init__(self, *, strict: bool = False):
        self.strict = strict
        self._mu = threading.Lock()
        # lock-order graph: edge a -> b == "b was acquired while a held"
        self._edges: Dict[str, Set[str]] = {}
        self._tls = threading.local()
        self.violations: List[str] = []

    def wrap(self, name: str, lock) -> "AuditedLock":
        return AuditedLock(self, name, lock)

    # ------------------------------------------------------- bookkeeping
    def _held(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _acquired(self, name: str):
        stack = self._held()
        if name not in stack:       # re-entrant frames add no edges
            tname = threading.current_thread().name
            with self._mu:
                for h in dict.fromkeys(stack):
                    self._edges.setdefault(h, set()).add(name)
                    if self._reachable_locked(name, h):
                        v = (f"lock order cycle: {h!r} -> {name!r} in "
                             f"thread {tname!r}, but {name!r} ->* {h!r} "
                             f"already recorded")
                        self.violations.append(v)
                        if self.strict:
                            raise LockOrderError(v)
        stack.append(name)

    def _released(self, name: str):
        stack = self._held()
        # release the innermost frame of this name (re-entrancy unwinds
        # inside-out; out-of-order release across *different* locks is
        # legal in Python and left alone)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    def _drop_all(self, name: str) -> int:
        """Condition.wait released the lock wholesale: drop every frame."""
        stack = self._held()
        n = stack.count(name)
        if n:
            self._tls.stack = [s for s in stack if s != name]
        return n

    def _reachable_locked(self, src: str, dst: str) -> bool:
        if src == dst:
            return True
        seen, frontier = {src}, [src]
        while frontier:
            nxt = frontier.pop()
            for m in self._edges.get(nxt, ()):
                if m == dst:
                    return True
                if m not in seen:
                    seen.add(m)
                    frontier.append(m)
        return False

    # --------------------------------------------------------- reduction
    def edges(self) -> Dict[str, Set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def assert_clean(self):
        if self.violations:
            raise LockOrderError(
                f"{len(self.violations)} lock-order violation(s):\n  "
                + "\n  ".join(self.violations))


class AuditedLock:
    """Transparent lock wrapper feeding a LockOrderAuditor."""

    def __init__(self, auditor: LockOrderAuditor, name: str, lock):
        self._aud = auditor
        self.name = name
        self._lock = lock

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._aud._acquired(self.name)
        return ok

    def release(self):
        self._aud._released(self.name)
        self._lock.release()

    def __enter__(self) -> "AuditedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._lock.locked()

    # Condition owner protocol (threading.Condition picks these up when
    # present, so `Condition(audited_rlock)` waits correctly even when
    # the lock is held re-entrantly)
    def _release_save(self):
        state = self._lock._release_save()
        self._aud._drop_all(self.name)
        return state

    def _acquire_restore(self, state):
        self._lock._acquire_restore(state)
        self._aud._acquired(self.name)

    def _is_owned(self) -> bool:
        return self._lock._is_owned()

    def __repr__(self):
        return f"AuditedLock({self.name!r}, {self._lock!r})"


class ExclusiveRegion:
    """Race assertion: at most one thread may be inside at a time.

    Wrapping an engine's `step` in one proves the single-owner invariant
    (only the replica's own worker ever drives its engine) instead of
    assuming it — a violation records both thread names."""

    def __init__(self, name: str):
        self.name = name
        self._mu = threading.Lock()
        self._owner: Optional[str] = None
        self.entries = 0
        self.violations: List[str] = []

    def __enter__(self) -> "ExclusiveRegion":
        me = threading.current_thread().name
        with self._mu:
            self.entries += 1
            if self._owner is not None:
                self.violations.append(
                    f"{self.name!r}: {me!r} entered while held by "
                    f"{self._owner!r}")
            else:
                self._owner = me
        return self

    def __exit__(self, *exc) -> bool:
        me = threading.current_thread().name
        with self._mu:
            if self._owner == me:
                self._owner = None
        return False

    def assert_clean(self):
        if self.violations:
            raise AssertionError(
                f"{len(self.violations)} exclusive-region violation(s):\n  "
                + "\n  ".join(self.violations))


def audit_serving_stack(gw, auditor: Optional[LockOrderAuditor] = None
                        ) -> LockOrderAuditor:
    """Re-wrap a Gateway's lock hierarchy with audited locks, in place.

    Call immediately after construction (before any worker starts): the
    gateway lock is swapped together with the conditions built on it, so
    wait/notify stay coherent. Returns the auditor; end the test with
    ``auditor.assert_clean()``."""
    aud = auditor or LockOrderAuditor()
    gw._lock = aud.wrap("gateway", gw._lock)
    gw._progress = threading.Condition(gw._lock)
    gw._work_ready = threading.Condition(gw._lock)
    gw.queue._lock = aud.wrap("queue", gw.queue._lock)
    gw.metrics._mu = aud.wrap("metrics", gw.metrics._mu)
    gw.registry._mu = aud.wrap("registry", gw.registry._mu)
    # continuous-telemetry leaves (when armed): the sampler appends and
    # the ledger attributes under their own locks, never calling out
    if getattr(gw, "sampler", None) is not None:
        gw.sampler._mu = aud.wrap("sampler", gw.sampler._mu)
    if getattr(gw, "ledger", None) is not None:
        gw.ledger._mu = aud.wrap("ledger", gw.ledger._mu)
    tr = otrace.active()
    if tr is not None:
        tr._mu = aud.wrap("tracer", tr._mu)
    return aud
