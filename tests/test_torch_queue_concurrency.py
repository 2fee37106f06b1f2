"""The port's TaskQueue under concurrent consumers, case for case the
reference's tests/test_queue_concurrency.py, with its seeds, sizes and
deadlines: exclusive delivery, exactly-once ack accounting, FIFO-seq
preservation through lease/release churn, journal replay consistency, and
heartbeat-vs-expiry semantics — the properties the port's async gateway
workers lean on.

Hypothesis drives a seed sweep when installed (via the `_hyp` shim), here
derandomized so its draws are the same in every run; the reference's fixed
seeded-parametrize sweep always runs regardless."""
import random
import threading
import time

import pytest

from _hyp import HAVE_HYPOTHESIS, given, settings, st
from repro_torch.core.queue import TaskQueue
from repro_torch.core.tasks import TaskSpec


def _spec(i, prio=0, retries=3):
    return TaskSpec(task_id=f"t{i}", session_id="s", kind="k",
                    payload={"i": i}, priority=prio, max_retries=retries)


class _DeliveryLedger:
    """Cross-thread assertion state: which ids are currently leased by a
    test consumer, and which have been acked."""

    def __init__(self):
        self.mu = threading.Lock()
        self.held = set()
        self.acked = []
        self.double_delivery = []

    def on_get(self, tid):
        with self.mu:
            if tid in self.held:
                self.double_delivery.append(tid)
            self.held.add(tid)

    def on_drop(self, tid):
        with self.mu:
            self.held.discard(tid)

    def on_ack(self, tid):
        with self.mu:
            self.held.discard(tid)
            self.acked.append(tid)


def _stress(seed: int, n_tasks: int = 40, n_workers: int = 4,
            journal_path=None) -> TaskQueue:
    """Run `n_workers` consumer threads over one queue until every task is
    acked: each consumer randomly acks, releases, or extends its lease
    (seeded per-thread RNG). Asserts exclusive delivery and exactly-once
    ack on the way; returns the (closed-over) queue for further checks."""
    q = TaskQueue(journal_path)
    ledger = _DeliveryLedger()
    for i in range(n_tasks):
        q.put(_spec(i))
    stop = threading.Event()
    errs = []

    def consumer(wid):
        rng = random.Random(seed * 1000 + wid)
        try:
            while not stop.is_set():
                spec = q.get(lease_seconds=30.0)
                if spec is None:
                    time.sleep(0.0005)
                    continue
                ledger.on_get(spec.task_id)
                roll = rng.random()
                if roll < 0.25:
                    ledger.on_drop(spec.task_id)
                    assert q.release(spec.task_id)
                elif roll < 0.35:
                    assert q.extend_lease(spec.task_id, 30.0)
                    ledger.on_ack(spec.task_id)
                    q.ack(spec.task_id)
                else:
                    ledger.on_ack(spec.task_id)
                    q.ack(spec.task_id)
        except Exception as e:      # noqa: BLE001 — surfaced to the test
            errs.append(e)

    threads = [threading.Thread(target=consumer, args=(w,), daemon=True)
               for w in range(n_workers)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while len(ledger.acked) < n_tasks and time.monotonic() < deadline:
        time.sleep(0.005)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not errs, errs
    assert not ledger.double_delivery, \
        f"tasks delivered to two consumers at once: {ledger.double_delivery}"
    assert sorted(ledger.acked) == sorted(f"t{i}" for i in range(n_tasks)), \
        "lost or duplicate acks"
    assert len(ledger.acked) == len(set(ledger.acked))
    st_ = q.stats()
    assert st_["pending"] == 0 and st_["leased"] == 0
    return q


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1337])
def test_concurrent_consumers_exclusive_delivery(seed):
    _stress(seed)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=15, deadline=None, derandomize=True)
@given(st.integers(min_value=0, max_value=2**32 - 1))
def test_concurrent_consumers_exclusive_delivery_prop(seed):
    _stress(seed, n_tasks=20)


@pytest.mark.parametrize("seed", [3, 9])
def test_concurrent_journal_replays_consistent(seed, tmp_path):
    """The journal written under 4-thread churn replays to the same
    terminal state: nothing pending, every task acked, no dead letters —
    and a fresh queue on that journal agrees."""
    path = str(tmp_path / "q.jsonl")
    q = _stress(seed, n_tasks=30, journal_path=path)
    q.close()
    q2 = TaskQueue(path)
    stats = q2.stats()
    assert stats["pending"] == 0
    assert stats["acked"] == 30
    assert stats["dead"] == 0
    assert q2.get() is None
    q2.close()


def test_concurrent_journal_replay_preserves_unacked(tmp_path):
    """Tasks ack'd before a crash stay done; everything else survives
    replay as deliverable — at-least-once, under concurrent writers."""
    path = str(tmp_path / "q.jsonl")
    q = TaskQueue(path)
    for i in range(20):
        q.put(_spec(i))
    acked = set()
    mu = threading.Lock()

    def worker():
        for _ in range(5):
            spec = q.get(lease_seconds=30.0)
            if spec is None:
                return
            with mu:
                acked.add(spec.task_id)
            q.ack(spec.task_id)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    q.close()                       # "crash" after a partial run
    q2 = TaskQueue(path)
    survivors = set()
    while (spec := q2.get()) is not None:
        survivors.add(spec.task_id)
    assert survivors == {f"t{i}" for i in range(20)} - acked
    q2.close()


@pytest.mark.parametrize("seed", [2, 5, 11])
def test_release_churn_preserves_fifo(seed):
    """4 threads lease-and-release tasks concurrently (no acks); a final
    single-threaded drain must still see strict put order — release
    re-queues under the seq the lease held, and concurrent churn must not
    corrupt the heap's FIFO-within-priority ordering."""
    q = TaskQueue()
    n = 16
    for i in range(n):
        q.put(_spec(i))
    stop = threading.Event()
    errs = []

    def churner(wid):
        rng = random.Random(seed * 100 + wid)
        try:
            while not stop.is_set():
                spec = q.get(lease_seconds=30.0)
                if spec is None:
                    continue
                if rng.random() < 0.5:
                    q.extend_lease(spec.task_id, 30.0)
                q.release(spec.task_id)
        except Exception as e:      # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=churner, args=(w,), daemon=True)
               for w in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.25)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not errs, errs
    # churners may exit holding a lease; return those so the drain sees all
    for i in range(n):
        q.release(f"t{i}")
    order = []
    while (spec := q.get()) is not None:
        order.append(spec.task_id)
        q.ack(spec.task_id)
    assert order == [f"t{i}" for i in range(n)], \
        f"FIFO violated after concurrent lease/release churn: {order}"


def test_heartbeat_blocks_redelivery_until_it_stops():
    """A short-leased task kept alive by extend_lease heartbeats from its
    holder is never redelivered to a concurrent poller; once heartbeats
    stop, expiry redelivers it — the exact liveness contract the async
    gateway workers rely on."""
    q = TaskQueue()
    q.put(_spec(0))
    spec = q.get(lease_seconds=0.05)
    assert spec is not None
    stolen = []
    hold = threading.Event()

    def poller():
        while not hold.is_set():
            got = q.get(lease_seconds=0.05)
            if got is not None:
                stolen.append(got.task_id)
                return
            time.sleep(0.002)

    t = threading.Thread(target=poller, daemon=True)
    t.start()
    for _ in range(20):             # heartbeat for ~0.2s, 4x the lease
        assert q.extend_lease("t0", 0.05)
        time.sleep(0.01)
    assert stolen == [], "redelivered while heartbeats were flowing"
    # stop heartbeating: the poller must now win via lease expiry
    t.join(timeout=10)
    hold.set()
    assert stolen == ["t0"]
    assert q.stats()["expired"] == 1


@pytest.mark.parametrize("seed", [4, 8])
def test_concurrent_nack_paths_account_exactly(seed):
    """Mixed ack/nack under 4 threads: every task ends exactly once in
    acked or dead-lettered, never both, never lost."""
    q = TaskQueue()
    n = 24
    for i in range(n):
        q.put(_spec(i, retries=1))
    done = {"acked": set(), "dead": set()}
    mu = threading.Lock()
    errs = []

    def worker(wid):
        rng = random.Random(seed * 77 + wid)
        try:
            while True:
                with mu:
                    if len(done["acked"]) + len(done["dead"]) >= n:
                        return
                spec = q.get(lease_seconds=30.0)
                if spec is None:
                    time.sleep(0.0005)
                    continue
                if rng.random() < 0.4:
                    if q.nack(spec.task_id):
                        with mu:
                            done["dead"].add(spec.task_id)
                else:
                    q.ack(spec.task_id)
                    with mu:
                        done["acked"].add(spec.task_id)
        except Exception as e:      # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs
    assert not (done["acked"] & done["dead"])
    assert done["acked"] | done["dead"] == {f"t{i}" for i in range(n)}
    assert {t.task_id for t in q.dead_letters()} == done["dead"]
    assert q.stats()["pending"] == 0 and q.stats()["leased"] == 0
