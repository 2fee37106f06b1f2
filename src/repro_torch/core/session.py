"""Sessions — the paper's "Session ID" returned by the upload endpoint.

A session scopes one dataset + one sweep. Progress aggregates the queue and
the result store exactly like the paper's progress bar endpoint: jQuery
polled `done/total`; callers poll `Session.progress()`.

The port's copy of the reference's `repro.core.session`, imports rewritten.
"""
from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict

from repro_torch.core.queue import TaskQueue
from repro_torch.core.results import ResultStore


@dataclass
class Session:
    queue: TaskQueue
    results: ResultStore
    session_id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])
    total_tasks: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)
    created: float = field(default_factory=time.time)

    def register_tasks(self, n: int):
        self.total_tasks += n

    def progress(self) -> dict:
        done = self.results.count(self.session_id)
        ok = self.results.count(self.session_id, status="ok")
        failed = done - ok
        frac = done / self.total_tasks if self.total_tasks else 0.0
        return {"session_id": self.session_id, "total": self.total_tasks,
                "done": done, "ok": ok, "failed": failed, "fraction": frac,
                "finished": done >= self.total_tasks}

    def wait(self, poll: float = 0.05, timeout: float = 3600.0) -> dict:
        t0 = time.time()
        while True:
            p = self.progress()
            if p["finished"] or time.time() - t0 > timeout:
                return p
            time.sleep(poll)
