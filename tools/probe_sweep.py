#!/usr/bin/env python3
"""The paper's sweep experiments on one NVIDIA GPU, at the sizes of the
reference's sweep benchmarks (their non-smoke settings), through the port.

    python3 tools/probe_sweep.py [--sections 1,2,3,4,5,6]

Every row is printed beside the card's name and power limit; the last line
is one JSON object with every number. Nothing is written into
`benchmarks/` or a `BENCH_*.json`: queues and result stores live under the
git-ignored `build/probe_sweep/`.

1. Time against hidden layers (the paper's Fig. 5, finding F2): the queue
   plane, one worker, 1-5 hidden layers of width 512 (relu), 4 epochs of
   a 2,400-row dataset (12 features, 4 classes), seeds 0 and 1; the mean
   steady epoch time (epoch 0 left out) per depth and its linear fit.
2. Queue throughput (Fig. 6): 20,000 jobs published to the journaled
   `TaskQueue`, drained with lease and ack, and the journal replayed (the
   host only: the broker runs no card work).
3. Worker status (Fig. 7): a pool of 4 workers over 12 tasks (1-2 layers
   of 16 or 32, three activation sets, 1 epoch of 600 rows) and 2 failing
   ones: throughput, workers engaged, failures absorbed, the dashboard's
   states.
4. The critical-mass table (F1, F3): the population plane, 2 hidden
   layers of width 2-128 at lr 3e-3 with three activation sets, 4 epochs
   of 1,500 rows, 4 seeds a design; accuracy against capacity and the
   critical mass (tolerance 0.02); then four activation sets at width 32.
5. Population against queue plane: the reference's search space (2 x 32
   at lr 1e-3 with its three default activation sets, seeds 0..K-1, 2
   epochs of 800 rows): 3 K tasks, one worker against three blocks of K,
   at K=16 (the reference's) and K=256 (the scheduler's max_block). Rates
   count all 3 K tasks (the reference's benchmark divides by K).
6. Worker scaling: pools of 1, 2 and 4 workers over the reference's 6
   tasks (1 layer of 8 or 16, seeds 0-2, 1 epoch of 400 rows), and over
   48 (seeds 0-23), tasks/s against one worker's.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402  (card_line)
from repro_torch.core import (ResultStore, SearchSpace, Session,  # noqa: E402
                              TaskQueue, TaskSpec, Worker, WorkerPool,
                              plan_sweep, reporting, train_population)
from repro_torch.data import pipeline, synthetic  # noqa: E402

DEVICE = "cuda"
OUT = ROOT / "build" / "probe_sweep"


def dataset(rows, features, classes, seed):
    return {"datasets": {"default": pipeline.prepare(
        synthetic.classification_csv(rows, features, classes, seed=seed),
        "label")}, "device": DEVICE}


def store(name):
    path = OUT / name
    path.mkdir(parents=True, exist_ok=True)
    return (TaskQueue(str(path / "q.journal")),
            ResultStore(str(path / "r.jsonl")))


def fig5() -> dict:
    q, rs = store("fig5")
    sess = Session(q, rs)
    space = SearchSpace(hidden_layer_counts=(1, 2, 3, 4, 5),
                        hidden_widths=(512,), activation_sets=(("relu",),),
                        epochs=4, batch_size=128, seeds=(0, 1))
    q.put_many(space.tasks(sess.session_id))
    Worker("w0", q, rs, dataset(2400, 12, 4, 5)).run_until_empty()
    groups = rs.aggregate("metrics.n_hidden_layers",
                          "metrics.steady_epoch_time", sess.session_id)
    rows = sorted((int(k), float(np.mean(v))) for k, v in groups.items())
    return {"rows": rows, "fit": reporting.linear_fit(rows),
            "failed": rs.count(sess.session_id, status="failed")}


def fig6(n_jobs=20_000) -> dict:
    path = OUT / "fig6"
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    q = TaskQueue(str(path / "fig6.journal"))
    specs = [TaskSpec(task_id=f"j{i}", session_id="fig6", kind="dnn_train",
                      payload={"hidden_sizes": [64], "i": i})
             for i in range(n_jobs)]
    t0 = time.perf_counter()
    q.put_many(specs)
    t_put = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = 0
    while (s := q.get()) is not None:
        q.ack(s.task_id)
        n += 1
    t_drain = time.perf_counter() - t0
    q.close()
    t0 = time.perf_counter()
    q2 = TaskQueue(str(path / "fig6.journal"))
    t_replay = time.perf_counter() - t0
    if n != n_jobs or q2.depth() != 0 or q2.stats()["acked"] != n_jobs:
        raise AssertionError(f"fig6: drained {n}, {q2.stats()}")
    return {"jobs": n_jobs, "enqueue_per_s": n_jobs / t_put,
            "drain_per_s": n_jobs / t_drain, "replay_s": t_replay}


def fig7(n_workers=4) -> dict:
    q, rs = store("fig7")
    sess = Session(q, rs)
    space = SearchSpace(hidden_layer_counts=(1, 2), hidden_widths=(16, 32),
                        epochs=1, batch_size=128)
    tasks = space.tasks(sess.session_id)
    tasks += [TaskSpec.make(sess.session_id, "dnn_train",
                            {"hidden_sizes": [16], "fail": True, "epochs": 1,
                             "n": i}, max_retries=0) for i in range(2)]
    q.put_many(tasks)
    pool = WorkerPool(n_workers, q, rs, dataset(600, 8, 3, 7))
    t0 = time.perf_counter()
    n = pool.run_until_empty()
    dt = time.perf_counter() - t0
    dash = pool.dashboard()
    return {"tasks": n, "workers": n_workers, "wall_s": dt,
            "tasks_per_s": n / dt,
            "engaged": sum(1 for d in dash if d["processed"] + d["failed"]),
            "failed": sum(d["failed"] for d in dash),
            "states": [d["state"] for d in dash],
            "backends": sorted({d["backend"] for d in dash})}


def critical_mass_table() -> dict:
    ctx = dataset(1500, 12, 4, 11)
    rs = ResultStore(str(OUT / "table.jsonl"))
    sess = Session(TaskQueue(), rs)
    tasks = []
    for w in (2, 4, 8, 16, 64, 128):
        tasks += SearchSpace(hidden_layer_counts=(2,), hidden_widths=(w,),
                             learning_rates=(3e-3,), epochs=4,
                             batch_size=128, seeds=(0, 1, 2, 3)
                             ).tasks(sess.session_id)
    t0 = time.perf_counter()
    for block in plan_sweep(tasks, min_block=2).population_blocks:
        train_population(block, ctx, results=rs)
    f1_s = time.perf_counter() - t0
    rows = reporting.accuracy_vs_capacity(rs, sess.session_id)
    sess2 = Session(TaskQueue(), rs)
    tasks = []
    for acts in (("relu",), ("tanh",), ("sigmoid",), ("relu", "tanh")):
        tasks += SearchSpace(hidden_layer_counts=(2,), hidden_widths=(32,),
                             activation_sets=(acts,), learning_rates=(3e-3,),
                             epochs=4, batch_size=128, seeds=(0, 1, 2, 3)
                             ).tasks(sess2.session_id)
    for block in plan_sweep(tasks, min_block=2).population_blocks:
        train_population(block, ctx, results=rs)
    by_act = reporting.accuracy_by_activation(rs, sess2.session_id)
    return {"capacity": rows,
            "critical_mass": reporting.critical_mass(rows, tol=0.02),
            "f1_s": f1_s, "activations": by_act,
            "activation_spread": max(by_act.values()) - min(by_act.values())}


def population_vs_queue(k) -> dict:
    ctx = dataset(800, 8, 3, 3)
    space = SearchSpace(hidden_layer_counts=(2,), hidden_widths=(32,),
                        learning_rates=(1e-3,), epochs=2, batch_size=128,
                        seeds=tuple(range(k)))
    q, rs = TaskQueue(), ResultStore()
    sess = Session(q, rs)
    n = len(space.tasks(sess.session_id))
    q.put_many(space.tasks(sess.session_id))
    t0 = time.perf_counter()
    Worker("w", q, rs, ctx).run_until_empty()
    t_queue = time.perf_counter() - t0
    rs2 = ResultStore()
    sess2 = Session(TaskQueue(), rs2)
    t0 = time.perf_counter()
    for b in plan_sweep(space.tasks(sess2.session_id),
                        min_block=2).population_blocks:
        train_population(b, ctx, results=rs2)
    t_pop = time.perf_counter() - t0
    ok = (rs.count(sess.session_id, status="ok"),
          rs2.count(sess2.session_id, status="ok"))
    if ok != (n, n):
        raise AssertionError(f"population vs queue, K={k}: ok {ok} of {n}")
    return {"k": k, "tasks": n, "queue_tasks_per_s": n / t_queue,
            "population_tasks_per_s": n / t_pop, "speedup": t_queue / t_pop}


def worker_scaling(seeds) -> list:
    ctx = dataset(400, 8, 3, 9)
    out, base = [], None
    for n in (1, 2, 4):
        q, rs = store(f"scaling_{len(seeds)}_{n}")
        sess = Session(q, rs)
        tasks = SearchSpace(hidden_layer_counts=(1,), hidden_widths=(8, 16),
                            activation_sets=(("relu",),), epochs=1,
                            batch_size=128, seeds=seeds
                            ).tasks(sess.session_id)
        q.put_many(tasks)
        t0 = time.perf_counter()
        done = WorkerPool(n, q, rs, ctx).run_until_empty()
        dt = time.perf_counter() - t0
        if done != len(tasks) or rs.count(sess.session_id, status="ok") \
                != len(tasks):
            raise AssertionError(f"worker scaling: {done} of {len(tasks)}")
        rate = done / dt
        base = base or rate
        out.append({"workers": n, "tasks": done, "tasks_per_s": rate,
                    "vs_one": rate / base})
    return out


def warm_up():
    """One task first, so cuBLAS's set-up is in no timing."""
    q, rs = TaskQueue(), ResultStore()
    q.put_many(SearchSpace(hidden_layer_counts=(2,), hidden_widths=(32,),
                           epochs=1).tasks("warm"))
    Worker("w", q, rs, dataset(400, 8, 3, 0)).run_until_empty()


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_sweep: torch sees no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", default="1,2,3,4,5,6",
                    help="comma-separated numbers of the experiments to run "
                    "(see the module docstring)")
    sections = {int(x) for x in ap.parse_args().sections.split(",")}
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    warm_up()
    out = {"card": card}

    def row(text):
        print(f"{text}  [{card}]", flush=True)

    if 1 in sections:
        r = out["fig5"] = fig5()
        for nl, t in r["rows"]:
            row(f"fig5 {nl} hidden layers of 512: steady epoch "
                f"{t * 1e3:.3f} ms")
        row(f"fig5 linear fit: {r['fit']['slope'] * 1e3:.3f} ms per layer, "
            f"intercept {r['fit']['intercept'] * 1e3:.3f} ms, r2 "
            f"{r['fit']['r2']:.4f}; failed {r['failed']}")
    if 2 in sections:
        r = out["fig6"] = fig6()
        row(f"fig6 {r['jobs']} jobs: enqueue {r['enqueue_per_s']:.0f} jobs/s, "
            f"drain {r['drain_per_s']:.0f} jobs/s, journal replay "
            f"{r['replay_s']:.3f} s (host only)")
    if 3 in sections:
        r = out["fig7"] = fig7()
        row(f"fig7 {r['tasks']} tasks on {r['workers']} workers in "
            f"{r['wall_s']:.3f} s ({r['tasks_per_s']:.2f} tasks/s), "
            f"{r['engaged']} engaged, {r['failed']} failures absorbed, "
            f"states {r['states']}, backends {r['backends']}")
    if 4 in sections:
        r = out["table"] = critical_mass_table()
        for cap, acc in r["capacity"]:
            row(f"table F1 capacity {cap} params: accuracy {acc:.4f}")
        row(f"table F1 critical mass {r['critical_mass']} params (tol 0.02); "
            f"the capacity sweep's blocks in {r['f1_s']:.3f} s")
        for act, acc in sorted(r["activations"].items()):
            row(f"table F3 {act}: accuracy {acc:.4f}")
        row(f"table F3 activation spread {r['activation_spread']:.4f}")
    if 5 in sections:
        out["population_vs_queue"] = []
        for k in (16, 256):
            r = population_vs_queue(k)
            out["population_vs_queue"].append(r)
            row(f"population vs queue, K={k} ({r['tasks']} tasks): queue "
                f"{r['queue_tasks_per_s']:.2f} tasks/s, population "
                f"{r['population_tasks_per_s']:.2f} tasks/s, speed-up "
                f"{r['speedup']:.2f}x")
    if 6 in sections:
        out["worker_scaling"] = {}
        for seeds in ((0, 1, 2), tuple(range(24))):
            rows = out["worker_scaling"][len(seeds) * 2] = worker_scaling(
                seeds)
            for r in rows:
                row(f"worker scaling, {r['tasks']} tasks: {r['workers']} "
                    f"worker(s) {r['tasks_per_s']:.2f} tasks/s "
                    f"({r['vs_one']:.2f}x one worker)")
    shutil.rmtree(OUT, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
