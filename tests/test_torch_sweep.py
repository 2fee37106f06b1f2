"""The port's sweep engine: the reference's tests/test_system.py case for
case on the port (upload -> preprocess -> enqueue sweep -> workers ->
results -> reporting, fail-forward isolation, an unknown kind, the
population plane against the queue plane, the LM executor), everything on
``device="cpu"``, and the host-side pieces held against the reference's:
the search space's payloads, the scheduler's split, a session's progress
and a worker's status document."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro import core as J  # noqa: E402
from repro_torch.core import (ResultStore, SearchSpace, Session,  # noqa: E402
                              TaskQueue, WorkerPool, plan_sweep, reporting,
                              train_population)
from repro_torch.core.tasks import TaskSpec  # noqa: E402
from repro_torch.core.worker import Worker  # noqa: E402
from repro_torch.data import pipeline, synthetic  # noqa: E402
from _torch_host import one_torch_thread  # noqa: E402,F401

CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def dataset():
    csv = synthetic.classification_csv(600, 8, 3, seed=0)
    return pipeline.prepare(csv, "label")


def _session(tmp_path, name):
    q = TaskQueue(os.path.join(tmp_path, f"{name}.journal"))
    rs = ResultStore(os.path.join(tmp_path, f"{name}.jsonl"))
    return Session(q, rs)


def _ctx(ds):
    return {"datasets": {"default": ds}, **CPU}


# ---- the reference's cases

def test_sweep_end_to_end(tmp_path, dataset):
    sess = _session(tmp_path, "e2e")
    space = SearchSpace(hidden_layer_counts=(1, 2), hidden_widths=(16,),
                        activation_sets=(("relu",),), epochs=1, batch_size=64)
    tasks = space.tasks(sess.session_id)
    sess.queue.put_many(tasks)
    sess.register_tasks(len(tasks))
    WorkerPool(2, sess.queue, sess.results, _ctx(dataset)).run_until_empty()
    p = sess.progress()
    assert p["finished"] and p["ok"] == len(tasks) and p["failed"] == 0
    for doc in sess.results.find(sess.session_id):
        assert 0.0 <= doc["metrics"]["accuracy"] <= 1.0
        assert doc["train_time"] > 0


def test_fail_forward_isolation(tmp_path, dataset):
    """A failing task is recorded + dead-lettered; healthy tasks complete."""
    sess = _session(tmp_path, "ff")
    good = SearchSpace(hidden_layer_counts=(1,), hidden_widths=(8,),
                       epochs=1, batch_size=64).tasks(sess.session_id)
    bad = [TaskSpec.make(sess.session_id, "dnn_train",
                         {"hidden_sizes": [8], "fail": True, "epochs": 1},
                         max_retries=0)]
    sess.queue.put_many(good + bad)
    sess.register_tasks(len(good) + len(bad))
    w = Worker("w0", sess.queue, sess.results, _ctx(dataset))
    w.run_until_empty()
    rep = reporting.failure_report(sess.results, sess.session_id)
    assert rep["failed"] >= 1                    # recorded, not crashed
    assert sess.results.count(sess.session_id, status="ok") == len(good)
    assert len(sess.queue.dead_letters()) == 1
    failed_doc = sess.results.find(sess.session_id, status="failed")[0]
    assert "injected failure" in failed_doc["error"]


def test_unknown_kind_fails_forward(tmp_path, dataset):
    sess = _session(tmp_path, "uk")
    sess.queue.put(TaskSpec.make(sess.session_id, "no_such_kind", {},
                                 max_retries=0))
    Worker("w", sess.queue, sess.results, dict(CPU)).run_until_empty()
    assert sess.results.count(sess.session_id, status="failed") == 1


def test_population_plane_matches_queue_plane(tmp_path, dataset):
    """Population (stacked) training produces accuracies on par with the
    queue plane for identical tasks — the two planes are interchangeable."""
    sess = _session(tmp_path, "pop")
    ctx = _ctx(dataset)
    space = SearchSpace(hidden_layer_counts=(2,), hidden_widths=(32,),
                        activation_sets=(("relu",),),
                        learning_rates=(1e-2,), epochs=3, batch_size=64,
                        seeds=(0, 1, 2, 3))
    tasks = space.tasks(sess.session_id)
    plan = plan_sweep(tasks, min_block=2)
    assert len(plan.population_blocks) == 1 and not plan.queue_tasks
    docs = train_population(plan.population_blocks[0], ctx,
                            results=sess.results)
    accs = [d["metrics"]["accuracy"] for d in docs]
    assert all(d["status"] == "ok" for d in docs)
    assert np.mean(accs) > 0.5                   # learned something real

    # queue plane on one identical task
    sess.queue.put(tasks[0])
    Worker("w", sess.queue, sess.results, ctx).run_until_empty()
    qdocs = sess.results.find(sess.session_id, status="ok",
                              task_id=tasks[0].task_id)
    qacc = [d["metrics"]["accuracy"] for d in qdocs
            if d["metrics"].get("population_size") is None]
    assert qacc and abs(qacc[0] - accs[0]) < 0.15


def test_reporting_pipeline(tmp_path, dataset):
    sess = _session(tmp_path, "rep")
    space = SearchSpace(hidden_layer_counts=(1, 2, 3), hidden_widths=(16,),
                        epochs=1, batch_size=64)
    sess.queue.put_many(space.tasks(sess.session_id))
    Worker("w", sess.queue, sess.results, _ctx(dataset)).run_until_empty()
    rows = reporting.time_vs_layers(sess.results, sess.session_id)
    assert [r[0] for r in rows] == [1, 2, 3]
    fit = reporting.linear_fit(rows)
    assert "slope" in fit and "r2" in fit
    cap = reporting.accuracy_vs_capacity(sess.results, sess.session_id)
    assert len(cap) == 3
    art = reporting.ascii_scatter(rows, xlabel="layers", ylabel="time")
    assert "*" in art
    md = reporting.to_markdown(rows, ["layers", "time"])
    assert md.count("|") > 6


def test_lm_train_executor(tmp_path):
    """The LM-zoo executor trains a reduced assigned arch via the queue."""
    sess = _session(tmp_path, "lm")
    sess.queue.put(TaskSpec.make(sess.session_id, "lm_train",
                                 {"arch": "qwen3-1.7b", "steps": 3,
                                  "batch_size": 2, "seq_len": 16}))
    Worker("w", sess.queue, sess.results, dict(CPU)).run_until_empty()
    docs = sess.results.find(sess.session_id, status="ok")
    assert len(docs) == 1
    assert np.isfinite(docs[0]["metrics"]["final_loss"])


# ---- against the reference

SPACES = [
    dict(),
    dict(hidden_layer_counts=(1, 2, 3, 4), hidden_widths=(8, 16, 32, 64, 128),
         activation_sets=(("relu",), ("tanh",), ("relu", "tanh")),
         learning_rates=(1e-3, 3e-3), optimizers=("adam", "sgd"), epochs=2,
         batch_size=128, seeds=(0, 1, 2, 3)),
]


@pytest.mark.parametrize("kw", SPACES, ids=["default", "wide"])
@pytest.mark.parametrize("n", [None, 40, 300])
def test_search_space_gives_the_reference_payloads(kw, n):
    port, ref = SearchSpace(**kw), J.SearchSpace(**kw)
    mine = port.tasks("s", n=n, seed=3)
    theirs = ref.tasks("s", n=n, seed=3)
    assert [t.payload for t in mine] == [t.payload for t in theirs]
    assert [t.task_id for t in mine] == [t.task_id for t in theirs]


@pytest.mark.parametrize("min_block,max_block", [(4, 256), (2, 256), (2, 3)])
def test_plan_gives_the_reference_split(min_block, max_block):
    kw = SPACES[1]
    mine = plan_sweep(SearchSpace(**kw).tasks("s", n=300, seed=1),
                      min_block=min_block, max_block=max_block)
    theirs = J.plan_sweep(J.SearchSpace(**kw).tasks("s", n=300, seed=1),
                          min_block=min_block, max_block=max_block)
    assert [[t.payload for t in b] for b in mine.population_blocks] == \
        [[t.payload for t in b] for b in theirs.population_blocks]
    assert [t.payload for t in mine.queue_tasks] == \
        [t.payload for t in theirs.queue_tasks]
    assert mine.n_tasks == theirs.n_tasks == 300


def test_progress_equals_the_reference(tmp_path):
    docs = [dict(task_id=f"t{i}", session_id="s",
                 status="ok" if i % 3 else "failed", train_time=0.1 * i,
                 metrics={"accuracy": 0.5}, params={"i": i})
            for i in range(7)]
    port = Session(TaskQueue(), ResultStore(), session_id="s")
    ref = J.Session(J.TaskQueue(), J.ResultStore(), session_id="s")
    for s in (port, ref):
        s.register_tasks(9)
        for d in docs:
            s.results.insert(**d)
    mine, theirs = port.progress(), ref.progress()
    assert mine == theirs and mine["done"] == 7 and not mine["finished"]


def test_worker_status_has_the_reference_keys(tmp_path, dataset):
    jw = J.Worker("w", J.TaskQueue(), J.ResultStore(), {})
    w = Worker("w", TaskQueue(), ResultStore(), _ctx(dataset))
    assert set(w.status()) == set(jw.status())
    assert w.status()["backend"] == "cpu" and w.status()["state"] == "idle"
    w.queue.put(TaskSpec.make("s", "dnn_train", {"hidden_sizes": [8],
                                                  "epochs": 1}))
    w.run_until_empty()
    st = w.status()
    assert (st["state"], st["processed"], st["failed"]) == ("stopped", 1, 0)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "seamless-m4t-large-v2", "pixtral-12b"])
def test_other_family_lm_train_gives_the_reference_losses(tmp_path,
                                                         monkeypatch, arch):
    """An `lm_train` task on an MoE, encoder-decoder or modality-prefix
    arch finishes `ok` through a Worker, and with the reference's weights
    (its `init_lm(PRNGKey(seed))` draw, bridged in place of the port's
    seeded draw) its first and last losses are the reference executor's
    within 1e-4 (the MoE aux and the stub inputs included)."""
    from repro.configs import registry as jreg
    from repro.core import executors as jax_executors
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    from repro_torch.params import params_from_jax

    payload = {"arch": arch, "steps": 3, "batch_size": 2, "seq_len": 16,
               "seed": 5}
    jparams = JT.init_lm(jax.random.PRNGKey(5), jreg.get(arch, reduced=True))
    monkeypatch.setattr(TT, "init_lm", lambda gen, cfg: params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device=str(gen.device)))
    sess = _session(tmp_path, "lm")
    sess.queue.put(TaskSpec.make(sess.session_id, "lm_train", payload,
                                 max_retries=0))
    Worker("w", sess.queue, sess.results, dict(CPU)).run_until_empty()
    (doc,) = sess.results.find(sess.session_id)
    assert doc["status"] == "ok", doc.get("error")
    want = jax_executors.lm_train(payload, {})
    for k in ("first_loss", "final_loss"):
        assert abs(doc["metrics"][k] - want[k]) <= 1e-4, (k, doc["metrics"],
                                                          want)


def test_cuda_without_a_card_stops_with_a_message(monkeypatch, dataset):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    block = SearchSpace(hidden_layer_counts=(1,), hidden_widths=(8,),
                        activation_sets=(("relu",),), epochs=1,
                        seeds=(0, 1)).tasks("s")
    for ctx in ({}, {"device": "cuda", "datasets": {"default": dataset}}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Worker("w", TaskQueue(), ResultStore(), ctx)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            WorkerPool(2, TaskQueue(), ResultStore(), ctx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_population(block, {"datasets": {"default": dataset}})
    from repro_torch.core import executors
    for fn, payload in ((executors.dnn_train, block[0].payload),
                        (executors.lm_train, {"arch": "qwen3-1.7b"})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(payload, {"datasets": {"default": dataset}})


def test_population_refuses_a_mesh(dataset):
    block = SearchSpace(hidden_layer_counts=(1,), hidden_widths=(8,),
                        activation_sets=(("relu",),), epochs=1,
                        seeds=(0, 1)).tasks("s")
    # a mesh is taken since the port is distributed; one whose population
    # axes do not divide the block is refused, where the reference would
    # fail to shard the members
    from repro_torch.sharding.rules import mesh_like
    with pytest.raises(ValueError, match="does not divide"):
        train_population(block, _ctx(dataset),
                         mesh=mesh_like((4,), ("data",)))
