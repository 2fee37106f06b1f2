"""Scheduler: splits a sweep between the two execution planes (DESIGN.md §2).

Tasks whose compiled program is identical (same shape signature — layer
sizes, activations, batch) are grouped into *population blocks* for the
vmapped data plane; the heterogeneous remainder goes to the queue/worker
control plane. On a mesh, one population block of size K occupies the
population (data) axis; adding chips raises K — the paper's "adding workers
is trivial", without per-task dispatch.

The port's copy of the reference's `repro.core.scheduler`, imports rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.core.tasks import TaskSpec, shape_signature


@dataclass
class Plan:
    population_blocks: List[List[TaskSpec]]
    queue_tasks: List[TaskSpec]

    @property
    def n_tasks(self) -> int:
        return sum(len(b) for b in self.population_blocks) + len(self.queue_tasks)


def plan_sweep(tasks: List[TaskSpec], *, min_block: int = 4,
               max_block: int = 256) -> Plan:
    """Group population-compatible tasks (equal shape signature) into blocks.
    Groups smaller than ``min_block`` aren't worth a block compile — they go
    to the queue. Oversized groups split into <= max_block chunks."""
    groups: Dict[Tuple[str, str], List[TaskSpec]] = {}
    for t in tasks:
        groups.setdefault((t.kind, shape_signature(t.payload)), []).append(t)
    blocks: List[List[TaskSpec]] = []
    queued: List[TaskSpec] = []
    for (_, _), g in sorted(groups.items()):
        if len(g) < min_block:
            queued.extend(g)
            continue
        for i in range(0, len(g), max_block):
            chunk = g[i:i + max_block]
            if len(chunk) < min_block:
                queued.extend(chunk)
            else:
                blocks.append(chunk)
    return Plan(population_blocks=blocks, queue_tasks=queued)
