"""Task specifications — the unit the paper serializes into RabbitMQ.

A TaskSpec is a fully declarative description of one training job: which
model family ("kind" — the paper's Keras-vs-PyBrain axis becomes the model
registry key), its config, optimizer settings and data reference. JSON round
trip is exact so tasks survive the journal and cross process boundaries.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class TaskSpec:
    task_id: str
    session_id: str
    kind: str                      # executor key, e.g. "dnn_train", "lm_train"
    payload: Dict[str, Any] = field(default_factory=dict)
    priority: int = 0
    max_retries: int = 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "TaskSpec":
        return TaskSpec(**json.loads(s))

    @staticmethod
    def make(session_id: str, kind: str, payload: Dict[str, Any],
             priority: int = 0, max_retries: int = 1) -> "TaskSpec":
        digest = hashlib.sha1(
            json.dumps([session_id, kind, payload], sort_keys=True,
                       default=str).encode()).hexdigest()[:16]
        return TaskSpec(task_id=f"{session_id}-{digest}", session_id=session_id,
                        kind=kind, payload=payload, priority=priority,
                        max_retries=max_retries)


def shape_signature(payload: Dict[str, Any]) -> str:
    """Signature of everything that changes the *compiled program*. Tasks with
    equal signatures are population-plane compatible (core/population.py):
    they can be stacked and vmapped; only seeds/lr may differ."""
    keys = ("hidden_sizes", "activations", "n_features", "n_classes",
            "batch_size", "epochs", "dataset", "optimizer", "dropout", "arch")
    sig = {k: payload.get(k) for k in keys}
    return hashlib.sha1(json.dumps(sig, sort_keys=True,
                                   default=str).encode()).hexdigest()[:12]
