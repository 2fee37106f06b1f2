"""The port's copy of tests/test_concurrency_harness.py, case for case:
repro_torch's tiny-config engines on the CPU (seeded torch weights,
`device="cpu"`). The reference's docstring follows.

The deterministic concurrency harness itself, the lock/race assertion
layer, and regression tests for the thread-safety fixes the async-worker
migration shipped with (observer-list mutation during notify, registry
get-or-create races, tracer ring corruption during export)."""
import threading
import time

import pytest

from _torch_host import one_torch_thread, shut_down_gateways  # noqa: F401
from repro_torch.concurrency import (AuditedLock, ExclusiveRegion,
                                     LockOrderAuditor, LockOrderError,
                                     ScheduleStall, StepBarrierScheduler)
from repro_torch.gateway.metrics import GatewayMetrics
from repro_torch.obs import trace as otrace
from repro_torch.obs.registry import Counter, MetricsRegistry


# -------------------------------------------------- step-barrier scheduler

def _run_participants(sched, names, body, join_timeout=30.0):
    """Spawn one thread per participant running `body(gate, name)`."""
    errs = []

    def runner(name):
        gate = sched.gate(name)
        try:
            body(gate, name)
        except ScheduleStall:
            pass
        except Exception as e:     # noqa: BLE001 — surfaced to the test
            errs.append(e)
        finally:
            sched.finish(name)

    threads = [threading.Thread(target=runner, args=(n,), daemon=True)
               for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=join_timeout)
    assert not any(t.is_alive() for t in threads), "participant hung"
    if errs:
        raise errs[0]


def test_scheduler_makes_races_deterministic_and_replayable():
    """A read-modify-write race with a checkpoint inside its window: the
    scheduler interleaves the read and write slices adversarially, so
    updates ARE lost — but identically on every run of the same seed.
    The race becomes a replayable artifact instead of a flake."""
    def one_run(seed):
        sched = StepBarrierScheduler(seed, ["a", "b", "c"])
        state = {"x": 0}

        def body(gate, name):
            for _ in range(5):
                gate.checkpoint("read")
                seen = state["x"]
                gate.checkpoint("write")
                state["x"] = seen + 1

        _run_participants(sched, ["a", "b", "c"], body)
        return state["x"], list(sched.trace)

    x1, tr1 = one_run(42)
    x2, tr2 = one_run(42)
    x3, tr3 = one_run(43)
    assert tr1 == tr2 and x1 == x2          # replay: byte-identical
    assert tr1 != tr3                       # new seed: new interleaving
    # the adversarial schedule actually exercised the race window
    assert x1 < 15
    assert len(tr1) == 30  # 3 participants x 5 iterations x 2 checkpoints


def test_scheduler_atomic_slices_never_lose_updates():
    """The same counter with the read-modify-write inside ONE slice (no
    checkpoint in the window): at most one participant runs between
    checkpoints, so the increment is effectively atomic and no schedule
    can lose an update."""
    for seed in (0, 42, 99):
        sched = StepBarrierScheduler(seed, ["a", "b", "c"])
        state = {"x": 0}

        def body(gate, name):
            for _ in range(5):
                gate.checkpoint("rmw")
                state["x"] += 1     # whole read-modify-write in one slice

        _run_participants(sched, ["a", "b", "c"], body)
        assert state["x"] == 15


def test_scheduler_without_barrier_exposes_lost_update():
    """The same non-atomic counter WITHOUT the harness, forced through a
    sleep in the read/write window, loses updates — the control showing
    the scheduler's serialization is what test_scheduler_serializes
    relies on, not luck."""
    state = {"x": 0}
    start = threading.Barrier(3)

    def body():
        start.wait()
        for _ in range(5):
            seen = state["x"]
            time.sleep(0.001)      # widen the race window
            state["x"] = seen + 1

    threads = [threading.Thread(target=body) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert state["x"] < 15         # racy interleaving loses increments


def test_scheduler_first_grant_waits_for_full_cast():
    """No slice is granted until every participant has arrived, so thread
    start order can't leak into the schedule."""
    sched = StepBarrierScheduler(0, ["a", "b"])
    order = []

    def slow_starter():
        time.sleep(0.05)
        gate = sched.gate("b")
        gate.checkpoint("go")
        order.append("b")
        sched.finish("b")

    t = threading.Thread(target=slow_starter, daemon=True)
    t.start()
    gate_a = sched.gate("a")
    gate_a.checkpoint("go")        # parks until b arrives, then one wins
    order.append("a")
    sched.finish("a")
    t.join(timeout=10)
    assert sorted(order) == ["a", "b"]
    assert len(sched.trace) >= 1


def test_scheduler_stall_raises_not_hangs():
    sched = StepBarrierScheduler(0, ["a", "b"], stall_timeout_s=0.2)
    # 'b' never arrives; 'a' must get ScheduleStall instead of hanging
    with pytest.raises(ScheduleStall):
        sched.checkpoint("a", "lonely")


def test_scheduler_finish_shrinks_barrier():
    sched = StepBarrierScheduler(1, ["a", "b"])
    sched.finish("b")              # b retired before ever arriving

    def body(gate, name):
        for _ in range(3):
            gate.checkpoint("tick")

    _run_participants(sched, ["a"], body)
    assert [n for n, _ in sched.trace] == ["a", "a", "a"]
    # checkpoint on a finished participant returns immediately
    sched.checkpoint("b", "late")


def test_scheduler_rejects_bad_participants():
    with pytest.raises(ValueError):
        StepBarrierScheduler(0, [])
    with pytest.raises(ValueError):
        StepBarrierScheduler(0, ["a", "a"])
    with pytest.raises(KeyError):
        StepBarrierScheduler(0, ["a"]).gate("zz")


# ----------------------------------------------------- lock-order auditor

def test_lock_order_cycle_detected():
    aud = LockOrderAuditor()
    a = aud.wrap("A", threading.Lock())
    b = aud.wrap("B", threading.Lock())
    with a:
        with b:                    # records A -> B
            pass
    with b:
        with a:                    # B -> A closes the cycle
            pass
    assert aud.violations
    with pytest.raises(LockOrderError):
        aud.assert_clean()


def test_lock_order_strict_raises_at_acquire():
    aud = LockOrderAuditor(strict=True)
    a = aud.wrap("A", threading.Lock())
    b = aud.wrap("B", threading.Lock())
    with a, b:
        pass
    with pytest.raises(LockOrderError):
        with b:
            a.acquire()


def test_lock_order_clean_hierarchy_passes():
    aud = LockOrderAuditor()
    gw = aud.wrap("gateway", threading.RLock())
    leaves = [aud.wrap(n, threading.Lock())
              for n in ("queue", "metrics", "tracer")]
    for _ in range(3):
        with gw:
            for leaf in leaves:
                with leaf:
                    pass
    aud.assert_clean()
    assert aud.edges()["gateway"] == {"queue", "metrics", "tracer"}


def test_audited_rlock_reentrancy_and_condition():
    """Re-entrant frames add no edges, and Condition built on a wrapped
    RLock waits/notifies correctly (the owner protocol delegation)."""
    aud = LockOrderAuditor(strict=True)
    lk = aud.wrap("L", threading.RLock())
    assert isinstance(lk, AuditedLock)
    with lk:
        with lk:                   # re-entrant, no self-edge
            pass
    aud.assert_clean()

    cond = threading.Condition(lk)
    hit = []

    def waiter():
        with cond:
            cond.wait(timeout=5)
            hit.append(True)

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    time.sleep(0.05)
    with cond:
        cond.notify_all()
    t.join(timeout=5)
    assert hit == [True]
    aud.assert_clean()


def test_exclusive_region_flags_overlap():
    reg = ExclusiveRegion("engine0.step")
    inside = threading.Event()
    release = threading.Event()

    def holder():
        with reg:
            inside.set()
            release.wait(timeout=5)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert inside.wait(timeout=5)
    with reg:                      # overlapping entry from another thread
        pass
    release.set()
    t.join(timeout=5)
    assert reg.violations
    with pytest.raises(AssertionError):
        reg.assert_clean()


def test_exclusive_region_sequential_is_clean():
    reg = ExclusiveRegion("r")
    for _ in range(4):
        with reg:
            pass
    reg.assert_clean()
    assert reg.entries == 4


# ------------------------------------------- thread-safety regression fixes

class _DetachingObserver:
    """Observer that removes itself from the list inside its hook — the
    pattern that used to silently skip the NEXT observer mid-iteration."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.events = 0

    def lifecycle(self, kind, m):
        self.events += 1
        self.metrics.observers.remove(self)


class _CountingObserver:
    def __init__(self):
        self.events = 0

    def lifecycle(self, kind, m):
        self.events += 1


def test_metrics_notify_survives_observer_self_removal():
    gm = GatewayMetrics(total_slots=2)
    det = _DetachingObserver(gm)
    after = _CountingObserver()
    gm.observers.extend([det, after])
    gm.submit(0, 4)
    # pre-fix: removing `det` shifted indices and the live-list iteration
    # skipped `after` for this event
    assert det.events == 1
    assert after.events == 1
    gm.dispatch(0, 0)
    assert after.events == 2       # detached observer stays detached
    assert det.events == 1


def test_metrics_concurrent_lifecycle_and_summary():
    """Hammer lifecycle edges from 4 threads while summary() reduces
    concurrently: counters must balance exactly and no iteration may
    throw (the gauges deque is iterated under the same lock)."""
    gm = GatewayMetrics(total_slots=8)
    N = 50
    errs = []

    def worker(base):
        try:
            for i in range(N):
                gid = base + i
                gm.submit(gid, 3)
                gm.dispatch(gid, base % 4)
                gm.token(gid)
                gm.record_gauges(i, 1)
                gm.finish(gid)
        except Exception as e:     # noqa: BLE001
            errs.append(e)

    def reducer():
        try:
            for _ in range(200):
                gm.summary()
        except Exception as e:     # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(k * 1000,))
               for k in range(4)] + [threading.Thread(target=reducer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs, errs
    s = gm.summary()
    assert s["completed"] == 4 * N
    assert s["dispatched"] == 4 * N
    assert s["illegal_transitions"] == 0


def test_registry_get_or_create_race_returns_one_instrument():
    reg = MetricsRegistry()
    start = threading.Barrier(8)
    got = []

    def body():
        start.wait()
        for _ in range(100):
            c = reg.counter("engine.races")
            c.inc()
        got.append(reg.counter("engine.races"))

    threads = [threading.Thread(target=body) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    # a lost creation race would fork the metric into two Counters and
    # split (lose) counts
    assert len({id(c) for c in got}) == 1
    assert isinstance(got[0], Counter)
    assert got[0].value == 800


def test_registry_snapshot_calls_providers_outside_lock():
    reg = MetricsRegistry()

    def provider():
        # a provider registering a scope at snapshot time must not
        # deadlock (snapshot copies the maps, then calls providers
        # lock-free)
        reg.register_scope("late", lambda: {"ok": 1})
        return {"seen": True}

    reg.register_scope("eager", provider)
    snap = reg.snapshot()
    assert snap["eager"] == {"seen": True}
    assert reg.snapshot()["late"] == {"ok": 1}


def test_tracer_concurrent_record_and_export():
    """Record spans from 4 threads while events()/export iterate the
    ring: pre-fix, deque mutation during iteration raised RuntimeError
    and truncated the Perfetto export."""
    tr = otrace.Tracer(capacity=256)
    stop = threading.Event()
    errs = []

    def recorder(tid):
        while not stop.is_set():
            with tr.span("work", tid=tid):
                pass
            tr.set_track_name(otrace.HOST_PID, tid, f"w{tid}")

    def exporter():
        try:
            for _ in range(50):
                evs = tr.events()
                assert isinstance(evs, list)
                tr.stats()
                len(tr)
        except Exception as e:     # noqa: BLE001
            errs.append(e)

    recs = [threading.Thread(target=recorder, args=(i,), daemon=True)
            for i in range(4)]
    exp = threading.Thread(target=exporter)
    for t in recs:
        t.start()
    exp.start()
    exp.join(timeout=30)
    stop.set()
    for t in recs:
        t.join(timeout=5)
    assert not errs, errs
    st = tr.stats()
    assert st["spans_recorded"] >= st["spans_buffered"]
    assert st["spans_buffered"] <= 256
