"""Workers — the Celery consumers of the system (the reference's
`repro.core.worker`).

A Worker pulls TaskSpecs from the queue, dispatches to an executor by
``spec.kind``, records a result document, and acks. Executor exceptions are
**fail-forward** exactly as the paper prescribes: the error is recorded as a
failed result, the task is nacked (requeue until max_retries, then
dead-letter) and the worker keeps pulling — one bad design never stalls the
sweep. A WorkerPool runs N workers on threads, as the reference's does.

Device awareness (the paper's THEANO_FLAGS=device=gpu): the context's
``"device"`` (default "cuda") is where every executor trains, and each
worker reports its type ("cuda" or "cpu") as ``backend`` in its status doc,
where the reference reports ``jax.default_backend()``. A CUDA worker runs
its tasks on a stream of its own, so one worker's host syncs wait only for
its own queued work, not for another worker's.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.queue import TaskQueue
from repro_torch.core.results import ResultStore

ExecutorFn = Callable[[Dict[str, Any], Dict[str, Any]], Dict[str, Any]]

_EXECUTORS: Dict[str, ExecutorFn] = {}


def context_device(context: Dict[str, Any]) -> torch.device:
    """The device a session context trains on: ``context["device"]``,
    "cuda" by default. Raises RuntimeError for a CUDA device torch cannot
    see: the sweep never falls back to the CPU unasked."""
    device = torch.device(context.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch sees no CUDA device; "
                           "put device='cpu' in the context to train on "
                           "the CPU")
    return device


def register_executor(kind: str):
    def deco(fn: ExecutorFn) -> ExecutorFn:
        _EXECUTORS[kind] = fn
        return fn
    return deco


def get_executor(kind: str) -> ExecutorFn:
    if kind not in _EXECUTORS:
        raise KeyError(f"no executor registered for kind={kind!r}; "
                       f"have {sorted(_EXECUTORS)}")
    return _EXECUTORS[kind]


class Worker:
    def __init__(self, worker_id: str, queue: TaskQueue, results: ResultStore,
                 context: Optional[Dict[str, Any]] = None):
        self.worker_id = worker_id
        self.queue = queue
        self.results = results
        self.context = context or {}
        self.device = context_device(self.context)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.state = "idle"            # idle | busy | stopped  (paper Fig 7)
        self.processed = 0
        self.failed = 0
        self.current: Optional[str] = None

    def run_one(self, lease_seconds: float = 300.0) -> bool:
        spec = self.queue.get(lease_seconds)
        if spec is None:
            return False
        self.state, self.current = "busy", spec.task_id
        t0 = time.perf_counter()
        try:
            executor = get_executor(spec.kind)
            with torch.cuda.stream(self._stream):
                metrics = executor(spec.payload, self.context)
            self.results.insert(
                task_id=spec.task_id, session_id=spec.session_id, status="ok",
                train_time=time.perf_counter() - t0, metrics=metrics,
                params=spec.payload)
            self.queue.ack(spec.task_id)
            self.processed += 1
        except Exception as e:               # fail forward
            self.failed += 1
            self.results.insert(
                task_id=spec.task_id, session_id=spec.session_id,
                status="failed", train_time=time.perf_counter() - t0,
                metrics={}, params=spec.payload,
                error=f"{type(e).__name__}: {e}\n{traceback.format_exc(limit=3)}")
            self.queue.nack(spec.task_id)
        finally:
            self.state, self.current = "idle", None
        return True

    def run_until_empty(self, lease_seconds: float = 300.0) -> int:
        n = 0
        while self.run_one(lease_seconds):
            n += 1
        self.state = "stopped"
        return n

    def status(self) -> dict:
        return {"worker_id": self.worker_id, "state": self.state,
                "processed": self.processed, "failed": self.failed,
                "current": self.current, "backend": self.device.type}


class WorkerPool:
    """N workers, thread-per-worker (the Celery `-c N` flag)."""

    def __init__(self, n: int, queue: TaskQueue, results: ResultStore,
                 context: Optional[Dict[str, Any]] = None):
        self.workers = [Worker(f"w{i}", queue, results, context)
                        for i in range(n)]

    def run_until_empty(self) -> int:
        threads = [threading.Thread(target=w.run_until_empty)
                   for w in self.workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return sum(w.processed + w.failed for w in self.workers)

    def dashboard(self) -> List[dict]:
        return [w.status() for w in self.workers]
