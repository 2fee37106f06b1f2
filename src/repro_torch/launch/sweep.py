"""The paper's sweep launcher: distributed DNN layer-design sweep.

    python -m repro_torch.launch.sweep --n-tasks 200 --workers 4 --plane auto

The port's copy of `repro.launch.sweep`, with the reference's flags,
search space, plan, output lines and artifacts. Builds (or loads) a CSV
dataset, enumerates/samples the search space, splits it across the
population (stacked members) and queue/worker planes, runs to completion,
and writes the paper's figures as text artifacts. Everything trains on
`--device` (default "cuda": without a CUDA device it stops, unless
`--device cpu` is given).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.core import (ResultStore, SearchSpace, Session, TaskQueue,
                              WorkerPool, plan_sweep, reporting,
                              train_population)
from repro_torch.data import pipeline, synthetic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", default=None, help="path to a CSV dataset")
    ap.add_argument("--label", default="label")
    ap.add_argument("--n-tasks", type=int, default=64)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--plane", choices=("auto", "queue", "population"),
                    default="auto")
    ap.add_argument("--out", default="sweep_out")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on; 'cpu' for tests")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[sweep] --device cuda, but torch sees no CUDA "
                         "device; pass --device cpu to sweep on the CPU")

    os.makedirs(args.out, exist_ok=True)
    if args.csv:
        with open(args.csv) as f:
            text = f.read()
    else:
        text = synthetic.classification_csv(2000, 12, 4, seed=args.seed)
    ds = pipeline.prepare(text, args.label, seed=args.seed)
    print(f"[sweep] dataset: {ds.x_train.shape[0]} train / "
          f"{ds.x_test.shape[0]} test, {ds.n_features} features, "
          f"{ds.n_classes} classes")

    queue = TaskQueue(os.path.join(args.out, "queue.journal"))
    results = ResultStore(os.path.join(args.out, "results.jsonl"))
    sess = Session(queue, results)
    ctx = {"datasets": {"default": ds}, "device": args.device}

    space = SearchSpace(
        hidden_layer_counts=(1, 2, 3, 4),
        hidden_widths=(8, 16, 32, 64, 128),
        activation_sets=(("relu",), ("tanh",), ("relu", "tanh")),
        learning_rates=(1e-3, 3e-3), epochs=args.epochs, batch_size=128,
        seeds=(0, 1, 2, 3))
    tasks = space.tasks(sess.session_id, n=args.n_tasks, seed=args.seed)
    sess.register_tasks(len(tasks))
    t0 = time.perf_counter()

    if args.plane == "queue":
        plan_blocks, plan_queue = [], tasks
    elif args.plane == "population":
        plan = plan_sweep(tasks, min_block=2)
        plan_blocks, plan_queue = plan.population_blocks, plan.queue_tasks
    else:
        plan = plan_sweep(tasks)
        plan_blocks, plan_queue = plan.population_blocks, plan.queue_tasks
    print(f"[sweep] {len(tasks)} tasks -> {len(plan_blocks)} population "
          f"blocks + {len(plan_queue)} queued")

    for block in plan_blocks:
        train_population(block, ctx, results=results)
    if plan_queue:
        queue.put_many(plan_queue)
        WorkerPool(args.workers, queue, results, ctx).run_until_empty()
    dt = time.perf_counter() - t0
    p = sess.progress()
    print(f"[sweep] {p['done']}/{p['total']} done ({p['failed']} failed) "
          f"in {dt:.1f}s — {p['done'] / dt:.2f} tasks/s")

    # --- the paper's figures ---
    sid = sess.session_id
    arts = {
        "fig5_time_vs_layers.txt": reporting.ascii_scatter(
            reporting.time_vs_layers(results, sid),
            xlabel="hidden layers", ylabel="train s"),
        "f1_accuracy_vs_capacity.txt": reporting.ascii_scatter(
            reporting.accuracy_vs_capacity(results, sid),
            xlabel="params", ylabel="accuracy", logx=True),
        "f3_activations.md": reporting.to_markdown(
            sorted(reporting.accuracy_by_activation(results, sid).items()),
            ["activations", "mean accuracy"]),
        "summary.md": reporting.to_markdown(
            [(k, v) for k, v in {**p, **reporting.failure_report(
                results, sid)}.items()], ["metric", "value"]),
    }
    for name, content in arts.items():
        with open(os.path.join(args.out, name), "w") as f:
            f.write(content + "\n")
        print(f"[sweep] wrote {args.out}/{name}")
    return 0


if __name__ == "__main__":
    main()
