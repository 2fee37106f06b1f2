"""Arm a `FaultPlan` against a live gateway.

The injector owns ZERO hooks in production code. It works by shadowing
bound methods with instance attributes — `eng.step = wrapper` — at the
exact seams the gateway already treats as failure domains:

  * `replica.engine.step`      — crash / straggler (dispatch-indexed)
  * `replica.engine._sample_safe` — NaN-logit corruption (call-indexed)
  * `gateway.step`             — the step clock; fires lease-expiry and
                                 opens/closes pool-pressure windows

`disarm()` deletes the shadows (the original bound methods reappear) and
releases any pool blocks still held, so a test/bench can interleave
faulted and clean phases on the same fleet. Everything that fired is
recorded in `self.fired` for assertions, and mirrored into the gateway's
flight recorder when one is armed.
"""
from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

import numpy as np

from repro_torch.chaos.faults import FaultPlan, FaultSpec, resolve_targets


class ChaosReplicaCrash(RuntimeError):
    """Injected replica death — distinguishable from organic failures in
    logs and flight dumps, identical to them in how the gateway reacts."""


class FaultInjector:
    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fired: List[dict] = []
        self._armed = False
        self._gw = None
        self._specs: List[FaultSpec] = []
        self._gw_step = 0                 # gateway-step clock
        self._dispatch: dict = {}         # replica idx -> engine.step count
        self._samples: dict = {}          # replica idx -> _sample_safe count
        self._held_blocks: dict = {}      # id(spec) -> (pool, [block ids])
        self._crashed: set = set()        # id(spec) of one-shot faults done
        # async gateways fire the dispatch clocks from worker threads and
        # the step clock from the consumer; one lock keeps every clock
        # increment + one-shot check atomic. The straggler sleep happens
        # OUTSIDE it (a held lock would serialize the very overlap the
        # fault exists to prove async mode hides). Per-replica dispatch
        # clocks stay deterministic regardless: only the owning worker
        # increments them.
        self._mu = threading.Lock()

    # ------------------------------------------------------------- arming
    def arm(self, gateway) -> "FaultInjector":
        if self._armed:
            raise RuntimeError("injector already armed")
        self._gw = gateway
        self._specs = resolve_targets(self.plan, len(gateway.replicas))
        if getattr(gateway, "async_workers", False) and \
                any(f.kind == "pool_pressure" for f in self._specs):
            # pool_pressure mutates a replica's BlockPool from the consumer
            # thread while that replica's worker may be mid-step on it —
            # a data race in the fault itself, not in the code under test
            raise ValueError(
                "pool_pressure faults are unsupported with async workers: "
                "the injector would mutate an engine's pool from outside "
                "its owner thread")
        for idx, rep in enumerate(gateway.replicas):
            mine = [f for f in self._specs
                    if f.replica == idx and f.kind in
                    ("crash", "straggler", "nan_logits")]
            if mine:
                self._wrap_replica(idx, rep.engine, mine)
        orig = gateway.step

        def chaos_gw_step(*a, **kw):
            self._on_gateway_step()
            return orig(*a, **kw)

        gateway.step = chaos_gw_step
        self._armed = True
        return self

    def _wrap_replica(self, idx: int, eng, specs: List[FaultSpec]):
        self._dispatch[idx] = 0
        self._samples[idx] = 0
        crashes = [f for f in specs if f.kind == "crash"]
        slows = [f for f in specs if f.kind == "straggler"]
        nans = [f for f in specs if f.kind == "nan_logits"]
        orig_step = eng.step

        def chaos_step(*a, **kw):
            sleep_s = 0.0
            with self._mu:
                d = self._dispatch[idx]
                self._dispatch[idx] = d + 1
                for f in crashes:
                    if d == f.at_dispatch and id(f) not in self._crashed:
                        self._crashed.add(id(f))
                        self._record("crash", replica=idx, dispatch=d)
                        raise ChaosReplicaCrash(
                            f"injected crash: replica {idx} dispatch {d}")
                for f in slows:
                    if f.at_dispatch <= d < f.until:
                        self._record("straggler", replica=idx, dispatch=d,
                                     delay_s=f.delay_s)
                        sleep_s += f.delay_s
            if sleep_s:
                # outside the lock: the straggler must stall only its own
                # replica, never peers firing their clocks concurrently
                time.sleep(sleep_s)
            return orig_step(*a, **kw)

        eng.step = chaos_step
        if nans:
            orig_sample = eng._sample_safe

            def chaos_sample(req, logits_row):
                with self._mu:
                    c = self._samples[idx]
                    self._samples[idx] = c + 1
                    for f in nans:
                        if c == f.at_dispatch and id(f) not in self._crashed:
                            self._crashed.add(id(f))
                            self._record("nan_logits", replica=idx, call=c,
                                         request_id=req.request_id)
                            logits_row = np.full(np.shape(logits_row),
                                                 np.nan, np.float32)
                return orig_sample(req, logits_row)

            eng._sample_safe = chaos_sample

    # ----------------------------------------------------- gateway clock
    def _on_gateway_step(self):
        with self._mu:
            s = self._gw_step
            self._gw_step = s + 1
            fire_lease = [f for f in self._specs
                          if f.kind == "lease_expiry" and s == f.at_step
                          and id(f) not in self._crashed]
            for f in fire_lease:
                self._crashed.add(id(f))
            pools = [f for f in self._specs if f.kind == "pool_pressure"]
        for f in fire_lease:
            q = self._gw.queue
            with q._lock:
                n = len(q._leased)
                for tid in q._leased:
                    q._leased[tid] = 0.0
            with self._mu:
                self._record("lease_expiry", step=s, leases=n)
        for f in pools:
            self._pool_window(f, s)

    def _pool_window(self, f: FaultSpec, s: int):
        key = id(f)
        if f.at_step <= s < f.until and key not in self._held_blocks:
            eng = self._gw.replicas[f.replica].engine
            pool = getattr(getattr(eng, "manager", None), "pool", None)
            if pool is None:      # dense engine: no pool to pressure
                return
            take = min(f.blocks, pool.free_count())
            self._held_blocks[key] = (pool, pool.alloc(take))
            self._record("pool_pressure", replica=f.replica, step=s,
                         blocks=take, phase="hold")
        elif s >= f.until and key in self._held_blocks:
            pool, blocks = self._held_blocks.pop(key)
            pool.decref(blocks)
            self._record("pool_pressure", replica=f.replica, step=s,
                         blocks=len(blocks), phase="release")

    # ---------------------------------------------------------- teardown
    def disarm(self):
        if not self._armed:
            return
        for pool, blocks in self._held_blocks.values():
            pool.decref(blocks)
        self._held_blocks.clear()
        if "step" in vars(self._gw):
            del self._gw.step
        for rep in self._gw.replicas:
            for name in ("step", "_sample_safe"):
                if name in vars(rep.engine):
                    delattr(rep.engine, name)
        self._armed = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.disarm()
        return False

    # ---------------------------------------------------------- evidence
    def _record(self, kind: str, **ctx):
        ev = {"fault": kind, "t": time.time(), **ctx}
        self.fired.append(ev)
        flight = getattr(self._gw, "flight", None)
        if flight is not None and hasattr(flight, "note"):
            flight.note(f"chaos_{kind}", **ctx)

    def count(self, kind: str) -> int:
        return sum(1 for e in self.fired if e["fault"] == kind)

    # ------------------------------------------------------ reload fault
    @staticmethod
    def truncate_journal(path: str, keep_frac: float = 1.0,
                         torn_bytes: Optional[int] = 17):
        """Apply the `journal_truncate` fault to a closed journal file:
        optionally drop whole tail records (keep_frac) and leave a torn
        partial record at the end (torn_bytes of the next record), the
        on-disk state a mid-write crash produces. `_replay` must recover
        every intact record and ignore the torn tail."""
        with open(path, "rb") as f:
            lines = f.readlines()
        keep = max(0, int(len(lines) * keep_frac))
        out = lines[:keep]
        if torn_bytes and keep < len(lines):
            out.append(lines[keep][:torn_bytes])
        with open(path, "wb") as f:
            f.writelines(out)
        return path


def plan_from_env(env: str = "REPRO_CHAOS_PLAN",
                  seed_env: str = "REPRO_CHAOS_SEED") -> Optional[FaultPlan]:
    """Build a plan from the environment (CI smoke jobs set these)."""
    from repro_torch.chaos.faults import parse_plan
    text = os.environ.get(env)
    if not text:
        return None
    return parse_plan(text, seed=int(os.environ.get(seed_env, "0")))
