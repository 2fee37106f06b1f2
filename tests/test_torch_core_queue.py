"""The port's copy of the durable task queue (repro_torch.core.queue and
repro_torch.core.tasks) against the reference's (repro.core).

First the reference's own cases of tests/test_core_queue.py, on the port's
TaskQueue and TaskSpec, with lease expiry driven by a controlled clock
instead of sleeps. Then three differential checks:

  * one seeded sequence of puts (duplicates and priorities included),
    leased gets, lease extensions, releases, acks, nacks to the dead
    letter, burials and clock advances drives both packages' queues in
    lockstep; every return value, depth(), stats(), dead_letters() and
    the journal (less its wall-time field) must agree after every step;
  * a journal written by either package's queue reopens in the other's
    with the same pending order, dead letters, depth and counters;
  * TaskSpec.make ids, JSON and shape_signature agree on seeded payloads.
"""
import json
import os
import random
import shutil
import types

import pytest

pytest.importorskip("jax")

from repro.core import queue as jqueue  # noqa: E402
from repro.core import tasks as jtasks  # noqa: E402
from repro_torch.core import queue as tqueue  # noqa: E402
from repro_torch.core import tasks as ttasks  # noqa: E402
from repro_torch.core.queue import TaskQueue  # noqa: E402
from repro_torch.core.tasks import TaskSpec, shape_signature  # noqa: E402


class _Clock:
    """A settable stand-in for the queue module's `time` (it reads only
    `time.time()`), so leases expire when a test says, not after a sleep."""

    def __init__(self, now=1_000.0):
        self.now = now

    def time(self):
        return self.now

    def advance(self, dt):
        self.now += dt


@pytest.fixture
def clock(monkeypatch):
    """One controlled clock, read by both packages' queue modules."""
    c = _Clock()
    fake = types.SimpleNamespace(time=c.time)
    monkeypatch.setattr(tqueue, "time", fake)
    monkeypatch.setattr(jqueue, "time", fake)
    return c


def _spec(i, prio=0, retries=1, sess="s"):
    return TaskSpec(task_id=f"t{i}", session_id=sess, kind="k",
                    payload={"i": i}, priority=prio, max_retries=retries)


# ------------------------------------------- the reference's cases, ported

def test_fifo_within_priority():
    q = TaskQueue()
    for i in range(5):
        q.put(_spec(i))
    got = [q.get().task_id for _ in range(5)]
    assert got == [f"t{i}" for i in range(5)]


def test_priority_order():
    q = TaskQueue()
    q.put(_spec(0, prio=0))
    q.put(_spec(1, prio=5))
    q.put(_spec(2, prio=1))
    assert [q.get().task_id for _ in range(3)] == ["t1", "t2", "t0"]


def test_leased_invisible_until_expiry(clock):
    q = TaskQueue()
    q.put(_spec(0))
    a = q.get(lease_seconds=0.05)
    assert a is not None and q.get() is None       # invisible while leased
    clock.advance(0.08)
    b = q.get()                             # lease expired -> redelivered
    assert b is not None and b.task_id == "t0"


def test_nack_retry_then_dead_letter():
    q = TaskQueue()
    q.put(_spec(0, retries=2))
    for _ in range(3):                              # initial + 2 retries
        spec = q.get()
        assert spec is not None
        q.nack(spec.task_id)
    assert q.get() is None
    assert [t.task_id for t in q.dead_letters()] == ["t0"]


def test_ack_removes():
    q = TaskQueue()
    q.put(_spec(0))
    q.ack(q.get().task_id)
    assert q.get() is None
    assert q.stats()["acked"] == 1


def test_journal_replay(tmp_path):
    path = os.path.join(tmp_path, "q.journal")
    q = TaskQueue(path)
    for i in range(4):
        q.put(_spec(i))
    q.ack(q.get().task_id)           # t0 done
    q.get()                           # t1 leased (lease is lost on crash)
    q.close()
    q2 = TaskQueue(path)              # "crash" recovery
    remaining = set()
    while (s := q2.get()) is not None:
        remaining.add(s.task_id)
    assert remaining == {"t1", "t2", "t3"}   # at-least-once: t1 redelivered
    assert q2.stats()["acked"] == 1


def test_shape_signature_ignores_lr_and_seed():
    base = {"hidden_sizes": [8, 8], "activations": 2}
    a = dict(base, lr=0.1, seed=1)
    b = dict(base, lr=0.2, seed=2)
    assert shape_signature(a) == shape_signature(b)
    assert shape_signature(dict(base, hidden_sizes=[999])) != \
        shape_signature(base)


def test_extend_lease_keeps_task_invisible(clock):
    q = TaskQueue()
    q.put(_spec(0))
    a = q.get(lease_seconds=0.05)
    assert a is not None
    assert q.extend_lease(a.task_id, 10.0)
    clock.advance(0.08)
    assert q.get() is None                 # heartbeat held the lease
    assert not q.extend_lease("missing", 1.0)


def test_duplicate_heap_entries_deliver_once(clock):
    """Expiry-requeue followed by a late nack leaves two heap entries for
    one task; a leased task must still be invisible to other consumers."""
    q = TaskQueue()
    q.put(_spec(0, retries=5))
    assert q.get(lease_seconds=0.01).task_id == "t0"
    clock.advance(0.02)               # lease expires (lazily)
    q.put(_spec(1, prio=5, retries=5))
    assert q.get().task_id == "t1"    # expiry requeues t0 (entry A)
    q.nack("t0")                      # late failure report -> entry B
    assert q.depth() == 1             # two heap entries, one deliverable
    a = q.get()                       # t0 redelivered once and leased...
    assert a is not None and a.task_id == "t0"
    assert q.depth() == 0             # stale dup entry is not phantom depth
    b = q.get()                       # ...duplicate entry must not deliver
    assert b is None


def test_taskspec_json_roundtrip():
    s = _spec(7, prio=3)
    assert TaskSpec.from_json(s.to_json()) == s


# ------------------------------------------------ differential: the walk

_OPS = ("put", "put_dup", "put_many", "get", "extend", "extend_many",
        "release", "ack", "nack", "bury", "advance")


def _observe(q):
    return (q.depth(), q.stats(), [t.to_json() for t in q.dead_letters()])


def _journal(path):
    """The journal's records without their wall-time field."""
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    for r in recs:
        r.pop("t")
    return recs


def _walk(seed, clock, dirpath, n_ops=400):
    """Drive a reference and a port queue, each journaled under `dirpath`,
    with one seeded sequence; assert agreement after every step. Returns
    the operation log (kind, result) and the journal paths."""
    rng = random.Random(seed)
    paths = {name: os.path.join(dirpath, f"{name}.jsonl")
             for name in ("ref", "port")}
    sides = {"ref": (jqueue.TaskQueue(paths["ref"]), jtasks),
             "port": (tqueue.TaskQueue(paths["port"]), ttasks)}
    ids = []                       # every id put so far
    got = []                       # ids handed out by get, newest last
    log = []
    for step in range(n_ops):
        kind = rng.choice(_OPS) if ids else "put"
        # every draw is made once, before either queue sees the op
        prio, retries, w = rng.randrange(4), rng.randrange(3), rng.random()
        # lease-bound ops mostly name a task handed out lately, so that
        # most of them find it still leased
        target = rng.choice(got[-4:] if got and rng.random() < 0.7
                            else ids + ["missing"])
        known = rng.choice(got[-4:] if got and rng.random() < 0.7
                           else ids) if ids else None
        some = rng.sample(ids, min(3, len(ids)))
        secs = rng.choice([0.5, 1.0, 2.0, 5.0])
        new = {"put": [len(ids)], "put_many": [len(ids) + k for k in range(3)],
               "put_dup": [int(known[1:])] if known else []}.get(kind, [])

        def specs(tasks):
            return [tasks.TaskSpec(task_id=f"t{i}", session_id=f"s{i % 3}",
                                   kind="k", payload={"i": i, "w": w},
                                   priority=prio, max_retries=retries)
                    for i in new]

        if kind == "advance":
            clock.advance(secs)
        results = {}
        for name, (q, tasks) in sides.items():
            if kind in ("put", "put_dup"):
                out = q.put(specs(tasks)[0])
            elif kind == "put_many":
                out = q.put_many(specs(tasks))
            elif kind == "get":
                spec = q.get(lease_seconds=secs)
                out = None if spec is None else spec.to_json()
            elif kind == "extend":
                out = q.extend_lease(target, secs)
            elif kind == "extend_many":
                out = q.extend_leases(some, secs)
            elif kind == "release":
                out = q.release(target)
            elif kind == "ack":
                out = q.ack(known)
            elif kind == "nack":
                out = q.nack(known)
            elif kind == "bury":
                out = q.bury(target)
            else:
                out = None
            results[name] = (out, _observe(q))
        assert results["port"] == results["ref"], (seed, step, kind)
        if kind in ("put", "put_many"):
            ids += [f"t{i}" for i in new]
        elif kind == "get" and results["ref"][0] is not None:
            got.append(json.loads(results["ref"][0])["task_id"])
        log.append((kind, results["ref"][0]))
    for q, _ in sides.values():
        q.close()
    assert _journal(paths["port"]) == _journal(paths["ref"])
    return log, paths


def _kinds(log, journal):
    """What a walk exercised: the ops it called, the outcomes that only a
    return value tells apart (a get that leased, an extension or release
    that found its lease, a nack that dead-lettered, a bury that buried),
    and every journal record kind (lease expiry among them)."""
    done = {kind for kind, out in log}
    done |= {"lease" for kind, out in log if kind == "get" and out}
    done |= {"extended" for kind, out in log
             if kind.startswith("extend") and out}
    done |= {"released" for kind, out in log if kind == "release" and out}
    done |= {"dead_letter" for kind, out in log if kind == "nack" and out}
    done |= {"buried" for kind, out in log if kind == "bury" and out}
    done |= {r["op"] for r in journal}
    return done


_EXPECTED = {"put", "put_dup", "put_many", "lease", "extended", "released",
             "ack", "nack", "dead_letter", "buried", "advance", "expire"}


@pytest.mark.parametrize("seed", range(4))
def test_queue_walk_matches_reference(seed, clock, tmp_path):
    log, paths = _walk(seed, clock, tmp_path)
    kinds = _kinds(log, _journal(paths["ref"]))
    assert _EXPECTED <= kinds, _EXPECTED - kinds


# --------------------------------------- differential: cross-package replay

def _reopened(mod, path):
    """What a queue of package `mod` recovers from the journal at `path`:
    its depth, counters and dead letters on reopening, then the order in
    which it hands out every pending task."""
    q = mod.TaskQueue(path)
    state = (q.depth(), q.stats(), [t.to_json() for t in q.dead_letters()])
    order = []
    while (s := q.get()) is not None:
        order.append(s.to_json())
    q.close()
    return state, order


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("seed", range(3))
def test_journal_replays_across_packages(writer, reader, seed, clock,
                                         tmp_path):
    """A journal written by one package's queue (a seeded walk: puts,
    leases left outstanding, acks, nacks, dead letters, burials, expiries)
    reopens in the other package's queue as it does in its own."""
    _, paths = _walk(100 + seed, clock, tmp_path, n_ops=200)
    mods = {"ref": jqueue, "port": tqueue}
    own = str(tmp_path / "own.jsonl")
    other = str(tmp_path / "other.jsonl")
    shutil.copy(paths[writer], own)
    shutil.copy(paths[writer], other)
    native = _reopened(mods[writer], own)
    crossed = _reopened(mods[reader], other)
    assert crossed == native
    (depth, stats, dead), order = native
    assert depth == len(order) > 0 and dead and stats["acked"] > 0


# ------------------------------------------- differential: ids, signatures

def _payload(rng, depth=0):
    """A seeded payload of the shapes tasks carry: the signature's keys
    among others, nested lists and dicts, floats, strings and None."""
    keys = ["hidden_sizes", "activations", "n_features", "n_classes",
            "batch_size", "epochs", "dataset", "optimizer", "dropout",
            "arch", "lr", "seed", "note"]
    out = {}
    for k in rng.sample(keys, rng.randrange(len(keys) + 1)):
        roll = rng.randrange(6)
        if roll == 0:
            out[k] = rng.randrange(-5, 1000)
        elif roll == 1:
            out[k] = rng.random()
        elif roll == 2:
            out[k] = [rng.randrange(64) for _ in range(rng.randrange(4))]
        elif roll == 3:
            out[k] = rng.choice(["adam", "sgd", "mnist", "qwen3-1.7b", ""])
        elif roll == 4 and depth < 2:
            out[k] = _payload(rng, depth + 1)
        else:
            out[k] = None
    return out


def test_taskspec_ids_and_signatures_match_reference():
    rng = random.Random(0)
    for _ in range(200):
        payload = _payload(rng)
        sess = rng.choice(["s0", "sweep-a", "gw"])
        kind = rng.choice(["dnn_train", "lm_train", "serve"])
        prio, retries = rng.randrange(-2, 5), rng.randrange(4)
        t = ttasks.TaskSpec.make(sess, kind, payload, prio, retries)
        j = jtasks.TaskSpec.make(sess, kind, payload, prio, retries)
        assert t.to_json() == j.to_json()
        assert ttasks.TaskSpec.from_json(j.to_json()).to_json() == \
            t.to_json()
        assert ttasks.shape_signature(payload) == \
            jtasks.shape_signature(payload)
