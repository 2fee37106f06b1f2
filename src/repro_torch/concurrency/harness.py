"""Seeded step-barrier scheduler: adversarial interleavings as replayable seeds.

Threaded code fails on *interleavings*, and the OS scheduler neither
explores them adversarially nor reproduces the one that failed. This
harness makes the interleaving a controlled input: participant threads
call ``checkpoint(label)`` at their yield points (the gateway's replica
workers take an optional ``gate`` for exactly this); the scheduler parks
every caller until **all** live participants are parked, then grants
exactly one — chosen by a seeded RNG — the right to run to its next
checkpoint. At most one participant executes between checkpoints, so

  * the whole run is serialized -> data races cannot hide behind timing,
    and every shared-state interaction happens in a recorded order;
  * the grant sequence (``trace``) is a pure function of the seed and the
    participants' (deterministic) behavior -> the same seed replays the
    same interleaving, byte for byte;
  * sweeping seeds explores distinct adversarial schedules for free.

Threads outside the participant set (the test's main thread pumping
`gateway.step`) run unscheduled; they must only *observe* shared state
through the code under test's own locks, which holds for the gateway
consumer API.

A participant that stops (worker shutdown) must be retired with
``finish(name)`` so the barrier shrinks; `checkpoint` on a finished name
returns immediately, which is what lets a stopped worker drain out of its
loop. A grant that never comes back (the scheduled code deadlocked)
raises `ScheduleStall` in every parked thread instead of hanging the
suite.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


class ScheduleStall(RuntimeError):
    """No grant progressed within the stall timeout: the code under test
    deadlocked (or a participant blocked outside any checkpoint)."""


class _Gate:
    """The per-participant handle workers receive: binds a fixed name so
    production code stays ignorant of the scheduler ('gate.checkpoint(
    label)' is the whole contract)."""
    __slots__ = ("_sched", "name")

    def __init__(self, sched: "StepBarrierScheduler", name: str):
        self._sched = sched
        self.name = name

    def checkpoint(self, label: str = ""):
        self._sched.checkpoint(self.name, label)

    def finish(self):
        self._sched.finish(self.name)


class StepBarrierScheduler:
    def __init__(self, seed: int, participants: Sequence[str], *,
                 stall_timeout_s: float = 30.0):
        if not participants:
            raise ValueError("need at least one participant")
        self._names = tuple(dict.fromkeys(participants))
        if len(self._names) != len(participants):
            raise ValueError(f"duplicate participant names: {participants}")
        self.seed = seed
        self._rng = random.Random(seed)
        self._cond = threading.Condition()
        self._arrived: set = set()
        self._parked: Dict[str, str] = {}         # name -> checkpoint label
        self._finished: set = set()
        self._current: Optional[str] = None       # holder of the grant
        self._stall_s = stall_timeout_s
        self._dead = False                        # a stall poisoned the run
        # grant log: (participant, label-at-grant) in execution order —
        # the interleaving, as data. Equality across runs == replay.
        self.trace: List[Tuple[str, str]] = []

    def gate(self, name: str) -> _Gate:
        if name not in self._names:
            raise KeyError(f"unknown participant {name!r}")
        return _Gate(self, name)

    # ------------------------------------------------------------- barrier
    def checkpoint(self, name: str, label: str = ""):
        """Park until the seeded RNG grants `name` the next slice. The
        first grant is not issued until every participant has arrived
        once, so startup thread-creation order cannot leak into the
        schedule."""
        with self._cond:
            if name in self._finished:
                return
            self._arrived.add(name)
            if self._current == name:       # yielding the slice we held
                self._current = None
            self._parked[name] = label
            self._maybe_grant_locked()
            deadline = time.monotonic() + self._stall_s
            while self._current != name:
                if name in self._finished:
                    return
                if self._dead:
                    raise ScheduleStall("scheduler poisoned by an earlier "
                                        "stall")
                self._cond.wait(timeout=0.05)
                if time.monotonic() > deadline and self._current != name:
                    self._dead = True
                    self._cond.notify_all()
                    raise ScheduleStall(
                        f"{name!r} waited >{self._stall_s}s at "
                        f"checkpoint {label!r}: parked={self._parked}, "
                        f"current={self._current!r}, "
                        f"finished={sorted(self._finished)}")
            del self._parked[name]

    def finish(self, name: str):
        """Retire a participant (worker stopped): it leaves the barrier
        and any thread still blocked in its checkpoint returns."""
        with self._cond:
            self._finished.add(name)
            self._parked.pop(name, None)
            if self._current == name:
                self._current = None
            self._maybe_grant_locked()
            self._cond.notify_all()

    def finish_all(self):
        for name in self._names:
            self.finish(name)

    def _maybe_grant_locked(self):
        if self._current is not None or self._dead:
            return
        live = set(self._names) - self._finished
        if not live:
            return
        # hold the first grant until the full cast has arrived
        if not live <= self._arrived:
            return
        runnable = sorted(n for n in self._parked if n in live)
        if set(runnable) != live:       # someone live is mid-slice
            return
        pick = self._rng.choice(runnable)
        self._current = pick
        self.trace.append((pick, self._parked[pick]))
        self._cond.notify_all()
