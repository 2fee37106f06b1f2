"""Persistent task queue — the RabbitMQ of the system, without the daemon.

Semantics (mirroring AMQP work-queues as the paper uses them):
  * ``put``      — publish, durable (journaled before visible).
  * ``get``      — consume with a lease (visibility timeout); a leased task
                   is invisible to other consumers until acked/nacked or the
                   lease expires (crash recovery — the paper's dispensable
                   workers).
  * ``ack``      — task done, removed.
  * ``nack``     — failure; requeued until max_retries, then dead-lettered.
  * priorities   — higher first, FIFO within a priority.

Durability: an append-only JSON-lines journal. Reopening a queue replays the
journal; outstanding leases are restored as pending (at-least-once delivery).
The journal is also the dashboard's data source (paper Fig 6).
"""
from __future__ import annotations

import heapq
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.tasks import TaskSpec


class TaskQueue:
    def __init__(self, journal_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._heap: List[Tuple[int, int, str]] = []   # (-priority, seq, id)
        self._seq = itertools.count()
        self._tasks: Dict[str, TaskSpec] = {}
        self._leased: Dict[str, float] = {}            # id -> deadline
        self._leased_seq: Dict[str, int] = {}          # id -> heap seq held
        # ids get() would actually deliver, maintained incrementally so
        # depth()/stats() are O(1) — the gateway polls depth every decode
        # step, and a set-scan over a deep backlog made that O(n) per token
        self._pending_ids: set = set()
        self._retries: Dict[str, int] = {}
        self._dead: List[str] = []
        self._acked: set = set()
        self._expired_count = 0
        self._journal_path = journal_path
        self._journal = None
        if journal_path:
            if os.path.exists(journal_path):
                self._replay(journal_path)
            self._journal = open(journal_path, "a", buffering=1)

    # ------------------------------------------------------------ journal
    def _log(self, op: str, **kw):
        # single-writer discipline: every journal append happens under the
        # queue lock, so records can never interleave mid-line and replay
        # order equals operation order — asserted, not assumed, now that
        # gateway worker threads drive the queue concurrently
        assert self._lock.locked(), \
            f"journal write {op!r} without the queue lock held"
        if self._journal:
            self._journal.write(json.dumps({"op": op, "t": time.time(), **kw})
                                + "\n")

    def _replay(self, path: str):
        with open(path) as f:
            lines = f.readlines()
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                # a crash mid-write leaves a torn final record; everything
                # before it is intact, so recover what we have. A torn line
                # anywhere *else* means real corruption — refuse to guess.
                if i == len(lines) - 1:
                    break
                raise
            self._apply_replayed(rec)
        # drop completed/dead from pending
        gone = self._acked | set(self._dead)
        self._heap = [h for h in self._heap if h[2] not in gone]
        heapq.heapify(self._heap)
        self._pending_ids = {h[2] for h in self._heap}

    def _apply_replayed(self, rec: dict):
        op = rec["op"]
        if op == "put":
            spec = TaskSpec.from_json(rec["task"])
            self._tasks[spec.task_id] = spec
            heapq.heappush(self._heap,
                           (-spec.priority, next(self._seq), spec.task_id))
        elif op == "ack":
            self._acked.add(rec["id"])
        elif op == "nack":
            self._retries[rec["id"]] = rec.get("retries", 0)
        elif op == "dead":
            self._dead.append(rec["id"])

    # ------------------------------------------------------------ api
    def put(self, spec: TaskSpec):
        with self._lock:
            self._log("put", task=spec.to_json())
            self._tasks[spec.task_id] = spec
            heapq.heappush(self._heap,
                           (-spec.priority, next(self._seq), spec.task_id))
            if spec.task_id not in self._leased:
                self._pending_ids.add(spec.task_id)

    def put_many(self, specs):
        for s in specs:
            self.put(s)

    def get(self, lease_seconds: float = 300.0) -> Optional[TaskSpec]:
        with self._lock:
            self._expire_locked()
            while self._heap:
                _, seq, tid = heapq.heappop(self._heap)
                # skip done/dead ids and duplicate heap entries for a task
                # that is currently leased (expiry-requeue followed by a
                # late nack leaves two entries; delivering both would hand
                # one task to two consumers concurrently)
                if tid in self._acked or tid in self._dead \
                        or tid in self._leased:
                    # a skipped entry is consumed: if a re-publish of an
                    # already-acked id put it back in the pending set, drop
                    # it or depth() would over-report forever (leased ids
                    # are never in the set; discard is a no-op there)
                    self._pending_ids.discard(tid)
                    continue
                self._leased[tid] = time.time() + lease_seconds
                self._leased_seq[tid] = seq
                self._pending_ids.discard(tid)
                self._log("lease", id=tid)
                return self._tasks[tid]
            return None

    def extend_lease(self, task_id: str, seconds: float = 300.0) -> bool:
        """Heartbeat: push a leased task's visibility deadline out by
        `seconds`. Long-running consumers (e.g. the serving gateway, whose
        decodes can outlast any fixed lease) call this each step so the task
        is not redelivered mid-flight. Returns False if the task is not
        currently leased (already acked/expired)."""
        with self._lock:
            if task_id not in self._leased:
                return False
            # not journaled: replay restores leases as pending anyway, so
            # extend records would be O(steps) dead weight in the journal
            self._leased[task_id] = time.time() + seconds
            return True

    def extend_leases(self, task_ids, seconds: float = 300.0) -> int:
        """Batch heartbeat under one lock acquisition: the gateway extends
        every in-flight lease immediately before (and after) each engine
        dispatch, so a dispatch that outlasts `lease_seconds` cannot let the
        queue re-deliver a request that is still decoding. Returns how many
        of the ids were actually leased (and therefore extended)."""
        deadline = time.time() + seconds
        n = 0
        with self._lock:
            for tid in task_ids:
                if tid in self._leased:
                    self._leased[tid] = deadline
                    n += 1
        return n

    def release(self, task_id: str) -> bool:
        """Voluntarily return a leased task to the pending queue *without*
        counting a retry — the consumer looked at it and cannot place it
        yet (e.g. the serving gateway's admission control found no replica
        with enough free KV blocks). Unlike nack this never dead-letters.
        Returns False if the task is not currently leased."""
        with self._lock:
            if task_id not in self._leased:
                return False
            del self._leased[task_id]
            spec = self._tasks[task_id]
            # re-queue under the seq the lease held so the task keeps its
            # FIFO position within its priority class — a capacity-deferred
            # request must not drop behind later-submitted peers (that
            # would starve large requests under sustained small-request
            # load). Not journaled: like extend_lease, a dispatch loop can
            # lease+release every step, and replay restores leases as
            # pending anyway — logging would be O(steps) dead weight.
            seq = self._leased_seq.pop(task_id, None)
            if seq is None:
                seq = next(self._seq)
            heapq.heappush(self._heap, (-spec.priority, seq, task_id))
            self._pending_ids.add(task_id)
            return True

    def ack(self, task_id: str):
        with self._lock:
            self._leased.pop(task_id, None)
            self._leased_seq.pop(task_id, None)
            self._pending_ids.discard(task_id)
            self._acked.add(task_id)
            self._log("ack", id=task_id)

    def nack(self, task_id: str) -> bool:
        """Failure: requeue up to max_retries, then dead-letter. Returns
        True when this nack dead-lettered the task (retries exhausted)."""
        with self._lock:
            self._leased.pop(task_id, None)
            self._leased_seq.pop(task_id, None)
            n = self._retries.get(task_id, 0) + 1
            self._retries[task_id] = n
            spec = self._tasks[task_id]
            if n > spec.max_retries:
                self._dead.append(task_id)
                self._pending_ids.discard(task_id)
                self._log("dead", id=task_id)
                return True
            self._log("nack", id=task_id, retries=n)
            heapq.heappush(self._heap,
                           (-spec.priority, next(self._seq), task_id))
            self._pending_ids.add(task_id)
            return False

    def bury(self, task_id: str) -> bool:
        """Administratively dead-letter a task regardless of its retry
        budget — the gateway's poison quarantine: a request that has killed
        multiple distinct replicas must never be offered to a consumer
        again, including across a journal reload (hence the journaled
        "dead" record). Returns False if the id is unknown or already
        done/dead."""
        with self._lock:
            if task_id not in self._tasks or task_id in self._acked \
                    or task_id in self._dead:
                return False
            self._leased.pop(task_id, None)
            self._leased_seq.pop(task_id, None)
            self._pending_ids.discard(task_id)
            self._dead.append(task_id)
            self._log("dead", id=task_id)
            return True

    def _expire_locked(self):
        now = time.time()
        expired = [tid for tid, dl in self._leased.items() if dl < now]
        for tid in expired:
            del self._leased[tid]
            self._leased_seq.pop(tid, None)
            self._expired_count += 1
            spec = self._tasks[tid]
            heapq.heappush(self._heap,
                           (-spec.priority, next(self._seq), tid))
            self._pending_ids.add(tid)
            self._log("expire", id=tid)

    # ------------------------------------------------------------ stats
    def _deliverable_locked(self) -> int:
        """Tasks that get() would actually hand out: excludes done/dead/
        leased ids and counts duplicate heap entries (expiry-requeue plus a
        late nack can leave two) once. O(1): the id set is maintained
        incrementally by put/get/ack/nack/release/expire."""
        return len(self._pending_ids)

    def depth(self) -> int:
        with self._lock:
            return self._deliverable_locked()

    def stats(self) -> dict:
        with self._lock:
            return {"pending": self._deliverable_locked(),
                    "leased": len(self._leased),
                    "acked": len(self._acked), "dead": len(self._dead),
                    "expired": self._expired_count}

    def dead_letters(self) -> List[TaskSpec]:
        with self._lock:
            return [self._tasks[t] for t in self._dead]

    def close(self):
        with self._lock:
            if self._journal:
                self._journal.close()
                self._journal = None
