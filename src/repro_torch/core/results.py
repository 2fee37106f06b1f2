"""Result store — the MongoDB of the system.

Append-only JSONL store of result documents. Fields mirror the paper: "the
session id, the training time, the model accuracy, and the parameters used
to train the model", plus status ("ok" / "failed") for fail-forward
accounting. Simple query API with kwarg equality filters and projections;
in-memory session index for the progress endpoint.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class ResultStore:
    def __init__(self, path: Optional[str] = None):
        self._lock = threading.Lock()
        self._docs: List[Dict[str, Any]] = []
        self._by_session: Dict[str, List[int]] = {}
        self._path = path
        self._fh = None
        if path:
            if os.path.exists(path):
                with open(path) as f:
                    for line in f:
                        if line.strip():
                            self._index(json.loads(line))
            self._fh = open(path, "a", buffering=1)

    def _index(self, doc: Dict[str, Any]):
        self._docs.append(doc)
        self._by_session.setdefault(doc.get("session_id", ""), []) \
            .append(len(self._docs) - 1)

    # ------------------------------------------------------------- write
    def insert(self, *, task_id: str, session_id: str, status: str,
               train_time: float, metrics: Dict[str, Any],
               params: Dict[str, Any], error: Optional[str] = None) -> dict:
        doc = {"task_id": task_id, "session_id": session_id, "status": status,
               "train_time": train_time, "metrics": metrics, "params": params,
               "error": error, "ts": time.time()}
        with self._lock:
            self._index(doc)
            if self._fh:
                self._fh.write(json.dumps(doc, default=float) + "\n")
        return doc

    # ------------------------------------------------------------- read
    def find(self, session_id: Optional[str] = None,
             where: Optional[Callable[[dict], bool]] = None,
             **eq) -> List[dict]:
        with self._lock:
            if session_id is not None:
                docs = [self._docs[i]
                        for i in self._by_session.get(session_id, [])]
            else:
                docs = list(self._docs)
        out = []
        for d in docs:
            if all(_get(d, k) == v for k, v in eq.items()) and \
                    (where is None or where(d)):
                out.append(d)
        return out

    def count(self, session_id: Optional[str] = None, **eq) -> int:
        return len(self.find(session_id, **eq))

    def aggregate(self, key: str, value: str,
                  session_id: Optional[str] = None) -> Dict[Any, List[float]]:
        """Group `value` field by `key` field (dotted paths ok)."""
        groups: Dict[Any, List[float]] = {}
        for d in self.find(session_id):
            k = _get(d, key)
            v = _get(d, value)
            if k is None or v is None:
                continue
            groups.setdefault(k, []).append(float(v))
        return groups

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def _get(doc: dict, dotted: str):
    cur: Any = doc
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur
