"""The paper's contribution: a distributed DNN layer-design sweep engine
(the reference's `repro.core`, on torch).

Control plane: TaskQueue (queue.py) + Worker/WorkerPool (worker.py) +
ResultStore (results.py) + Session (session.py) — the RabbitMQ/Celery/
MongoDB/Flask quartet of the 2015 system, journal-backed and daemon-free.
`queue`, `tasks`, `results`, `reporting`, `sweep`, `scheduler` and
`session` are the reference's host-only modules, copied with their imports
rewritten; `worker`, `executors` and `population` are ported and train on
the context's device ("cuda" unless the context says "cpu").

Data plane: plan_sweep (scheduler.py) + train_population (population.py) —
shape-homogeneous task blocks trained as members stacked on a leading axis
(the reference vmaps them).

SearchSpace (sweep.py) enumerates the layer designs; reporting.py renders
the paper's figures from stored results.
"""
from repro_torch.core.queue import TaskQueue  # noqa: F401
from repro_torch.core.results import ResultStore  # noqa: F401
from repro_torch.core.session import Session  # noqa: F401
from repro_torch.core.sweep import SearchSpace  # noqa: F401
from repro_torch.core.tasks import TaskSpec, shape_signature  # noqa: F401
from repro_torch.core.worker import (Worker, WorkerPool,  # noqa: F401
                                     register_executor)
from repro_torch.core import executors  # noqa: F401  (registers built-in executors)
from repro_torch.core.scheduler import plan_sweep  # noqa: F401
from repro_torch.core.population import train_population  # noqa: F401
from repro_torch.core import reporting  # noqa: F401
