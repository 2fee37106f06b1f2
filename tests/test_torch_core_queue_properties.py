"""Hypothesis property tests of the port's TaskQueue delivery and shape
signatures, case for case the reference's tests/test_core_queue_properties.py.
Each draw also goes through the reference's queue (repro.core), which must
deliver the same tasks in the same order and sign the same payloads alike.

Derandomized: the draws are a fixed function of each test, so the cases
and their count are the same in every run.
"""
import pytest

hypothesis = pytest.importorskip("hypothesis")
pytest.importorskip("jax")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import queue as jqueue  # noqa: E402
from repro.core import tasks as jtasks  # noqa: E402
from repro_torch.core.queue import TaskQueue  # noqa: E402
from repro_torch.core.tasks import TaskSpec, shape_signature  # noqa: E402

_SETTINGS = dict(max_examples=30, deadline=None, derandomize=True)


def _spec(i, prio=0, retries=1, sess="s", spec_cls=TaskSpec):
    return spec_cls(task_id=f"t{i}", session_id=sess, kind="k",
                    payload={"i": i}, priority=prio, max_retries=retries)


def _deliveries(queue_cls, spec_cls, prios):
    q = queue_cls()
    for i, p in enumerate(prios):
        q.put(_spec(i, prio=p, spec_cls=spec_cls))
    seen = []
    while (s := q.get()) is not None:
        seen.append(s.task_id)
        q.ack(s.task_id)
    return seen, q.stats()


@given(st.lists(st.integers(min_value=0, max_value=5), min_size=1,
                max_size=30))
@settings(**_SETTINGS)
def test_property_all_tasks_delivered_exactly_once_when_acked(prios):
    seen, stats = _deliveries(TaskQueue, TaskSpec, prios)
    assert sorted(seen) == sorted(f"t{i}" for i in range(len(prios)))
    # non-increasing priority order
    by_id = {f"t{i}": p for i, p in enumerate(prios)}
    deliv = [by_id[t] for t in seen]
    assert deliv == sorted(deliv, reverse=True)
    assert (seen, stats) == _deliveries(jqueue.TaskQueue, jtasks.TaskSpec,
                                        prios)


@given(st.dictionaries(st.sampled_from(["hidden_sizes", "lr", "seed",
                                        "activations"]),
                       st.integers(0, 3), min_size=0, max_size=4))
@settings(**_SETTINGS)
def test_shape_signature_ignores_lr_and_seed(payload):
    base = dict(payload)
    a = dict(base, lr=0.1, seed=1)
    b = dict(base, lr=0.2, seed=2)
    assert shape_signature(a) == shape_signature(b)
    c = dict(base, hidden_sizes=[999])
    if base.get("hidden_sizes") != [999]:
        assert shape_signature(c) != shape_signature(dict(base))
    for p in (base, a, b, c):
        assert shape_signature(p) == jtasks.shape_signature(p)
