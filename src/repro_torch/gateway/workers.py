"""Async replica workers: one thread per engine, pumping the durable queue.

This is the concurrency half of the paper's queue/worker story. In
synchronous mode the gateway's `step()` dispatches all N replicas from
one thread, so N replicas serialize on the token path and any stall on
one replica (a straggler, a long jit compile, a probation wait) blocks
the whole fleet. With `async_workers=True` each `EngineReplica` gets a
`ReplicaWorker` thread running this loop:

    pump:
      - own-replica lifecycle: if my replica is on probation and the
        window has elapsed, warm-reintegrate it (each worker reintegrates
        ONLY its own replica, so an engine reset can never race that
        engine's dispatches);
      - under the gateway lock: run the shared dispatch loop (policy
        placement, deadline/brownout shed, retry backoff, poison
        quarantine — the exact synchronous code path), then heartbeat
        the leases of tasks placed on *my* replica;
      - WITHOUT the gateway lock: `engine.step()` — device compute
        overlaps across workers; token/finish callbacks re-enter the
        gateway lock briefly;
      - a step exception is a replica crash: `_fail_replica` under the
        lock (nack/requeue/poison — the PR 8 lifecycle manager,
        unchanged);
      - heartbeat again, notify consumers, idle-wait when there was
        nothing to do.

Lease heartbeats (`extend_leases` immediately before and after each
engine dispatch) are the liveness signal: a worker that stops pumping
lets its leases lapse and the queue redelivers to surviving replicas.
A worker *thread* that dies is detected by the gateway's consumer pump
(`Gateway._step_async`), treated as a crash fault on its replica, and
the worker is respawned — supervision, so probation-based reintegration
still has an owner to run on.

The optional `gate` is the deterministic test hook: the concurrency
harness passes an object with `checkpoint(label)` (see
`repro_torch.concurrency.harness`), called at the loop's two yield points.
Production passes None — one attribute check per pump, no other cost.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from repro_torch.obs import trace as otrace

logger = logging.getLogger("repro_torch.gateway.workers")


class WorkerDied(RuntimeError):
    """A replica's worker thread exited without being stopped: surfaced
    to the lifecycle manager as a crash fault on that replica."""


class ReplicaWorker(threading.Thread):
    def __init__(self, gateway, replica, *, gate=None,
                 idle_wait_s: float = 0.001):
        super().__init__(
            name=f"replica-worker-{replica.replica_id}", daemon=True)
        self.gateway = gateway
        self.replica = replica
        self.gate = gate
        self.idle_wait_s = idle_wait_s
        self._stop_ev = threading.Event()
        self._die = threading.Event()       # test hook: simulate thread death
        self.stopped_deliberately = False
        # telemetry (racy reads are fine: monotonic ints, owner-written)
        self.pumps = 0
        self.engine_steps = 0
        self.pump_errors = 0

    # ------------------------------------------------------------ control
    def stop(self):
        """Deliberate shutdown: the thread drains out of its loop; the
        gateway will NOT treat the exit as a crash."""
        self.stopped_deliberately = True
        self._stop_ev.set()
        if self.gate is not None and hasattr(self.gate, "finish"):
            # retire from the harness barrier so a gated thread parked in
            # checkpoint() drains instead of deadlocking the scheduler
            self.gate.finish()

    def kill(self):
        """Test hook: make the thread exit as if it crashed — the
        gateway's supervision must notice, fail the replica, and respawn
        a worker for it."""
        self._die.set()

    # --------------------------------------------------------------- loop
    def run(self):
        rid = self.replica.replica_id
        otrace.set_track_name(otrace.HOST_PID, rid, f"replica{rid}")
        gw = self.gateway
        while not self._stop_ev.is_set():
            if self.gate is not None:
                self.gate.checkpoint("pump")
            if self._stop_ev.is_set():
                break
            if self._die.is_set():
                return                      # simulated crash: no cleanup
            self.pumps += 1
            try:
                progressed = self._pump()
            except Exception:   # noqa: BLE001 — a pump bug must not
                # silently kill the thread; log, count, keep serving
                self.pump_errors += 1
                logger.exception("replica %d worker pump failed", rid)
                progressed = False
            if not progressed and self.gate is None:
                # idle: wait for submit()/progress to kick us (timeout so
                # probation expiry and lease churn are still observed)
                with gw._work_ready:
                    gw._work_ready.wait(self.idle_wait_s)

    def _pump(self) -> bool:
        gw, rep = self.gateway, self.replica
        eng = rep.engine
        if not rep.healthy:
            if gw.probation_seconds is not None \
                    and rep.failed_at is not None \
                    and (time.perf_counter() - rep.failed_at
                         >= gw.probation_seconds):
                with gw._lock:
                    if not rep.healthy:     # re-check under the lock
                        gw._reintegrate(rep)
                        gw._work_ready.notify_all()
            else:
                return False
        with gw._lock:
            # shared dispatch: places work on ANY replica (the policy
            # decides); whichever worker pumps first drains the queue
            gw._dispatch_ready()
            if not eng.has_work():
                return False
            mine = [tid for tid, (_, r) in gw._inflight.items() if r is rep]
            if mine:
                gw.queue.extend_leases(mine, gw.lease_seconds)
        if self.gate is not None:
            self.gate.checkpoint("step")
        self.engine_steps += 1
        try:
            # the lock is NOT held here: this is the overlap — my device
            # compute runs while peers dispatch/step; on_token/on_finish
            # callbacks take the gateway lock for their brief bookkeeping
            eng.step()
        except Exception as err:    # noqa: BLE001 — fail forward
            with gw._lock:
                gw._fail_replica(rep, err)
                gw._progress.notify_all()
            return True
        with gw._lock:
            mine = [tid for tid, (_, r) in gw._inflight.items() if r is rep]
            if mine:
                # post-step heartbeat: a lease that lapsed *during* a long
                # dispatch is healed before any get() can observe it
                gw.queue.extend_leases(mine, gw.lease_seconds)
            gw._progress.notify_all()
            gw._work_ready.notify_all()
        return True

    def stats(self) -> dict:
        return {"replica": self.replica.replica_id, "alive": self.is_alive(),
                "pumps": self.pumps, "engine_steps": self.engine_steps,
                "pump_errors": self.pump_errors}
