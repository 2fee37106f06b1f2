"""The sweep on the card: the population plane and `dnn_train` on CUDA
agree with their CPU runs from the same weights (TF32 off), a two-worker
pool on the card (each worker on its own stream) finishes every task with
the accuracies of one worker, and workers report the "cuda" backend.

Skips cleanly where torch sees no CUDA device. Imports no JAX. Run on the
card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_sweep_cuda.py``.
"""
import math

import pytest
import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.core import (ResultStore, SearchSpace, TaskQueue, Worker,
                              WorkerPool)
from repro_torch.core import executors as TE
from repro_torch.core import population as TP
from repro_torch.core.tasks import TaskSpec
from repro_torch.data import pipeline, synthetic

pytestmark = pytest.mark.gpu
REL = 1e-4          # card against CPU: f32 sums in another order


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def dataset():
    return pipeline.prepare(synthetic.classification_csv(800, 12, 4, seed=1),
                            "label")


def _block(opt):
    lrs = (1e-2, 3e-3, 3e-2, 1e12 if opt == "sgd" else 1e-3)
    return [TaskSpec.make("s", "dnn_train", {
        "hidden_sizes": [64, 32], "activations": ["relu"], "lr": lr,
        "optimizer": opt, "epochs": 2, "batch_size": 64, "seed": s})
        for s, lr in enumerate(lrs)]


def _close(card, cpu):
    for a, b in zip(tree_leaves(card), tree_leaves(cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=REL * b.abs().max().item())


def _loss_close(a, b):
    """Within REL; a diverged member's loss only non-finite on both."""
    if math.isfinite(b):
        assert abs(a - b) <= REL * abs(b), (a, b)
    else:
        assert not math.isfinite(a), (a, b)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_population_on_the_card_equals_the_cpu(device, dataset, opt,
                                               monkeypatch):
    block = _block(opt)
    cpu_draw = TP.population_params([0, 1, 2, 3], TP._block_config(
        block, dataset), "cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev, copy=True), cpu_draw)
        monkeypatch.setattr(TP, "population_params", lambda *a: params)
        docs = TP.train_population(block, {"datasets": {"default": dataset},
                                           "device": dev})
        runs[dev] = (docs, params)
    (cpu_docs, cpu_params), (card_docs, card_params) = runs["cpu"], \
        runs["cuda"]
    assert [d["status"] for d in card_docs] == [d["status"] for d in cpu_docs]
    if opt == "sgd":
        assert [d["status"] for d in card_docs][-1] == "failed"
    for a, b in zip(card_docs, cpu_docs):
        _loss_close(a["metrics"]["final_loss"], b["metrics"]["final_loss"])
    ok = [i for i, d in enumerate(cpu_docs) if d["status"] == "ok"]
    _close(tree_map(lambda t: t[ok], card_params),
           tree_map(lambda t: t[ok], cpu_params))


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_dnn_train_on_the_card_equals_the_cpu(device, dataset, opt,
                                              monkeypatch):
    payload = _block(opt)[0].payload
    cfg = TE._mlp_config(payload, dataset)
    cpu_draw = TE.member_params(0, cfg, "cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev, copy=True), cpu_draw)
        monkeypatch.setattr(TE, "member_params", lambda *a: params)
        runs[dev] = (TE.dnn_train(payload, {"datasets": {"default": dataset},
                                            "device": dev}), params)
    _loss_close(runs["cuda"][0]["final_loss"], runs["cpu"][0]["final_loss"])
    _close(runs["cuda"][1], runs["cpu"][1])


def test_two_workers_on_the_card_match_one(device, dataset):
    space = SearchSpace(hidden_layer_counts=(1, 2), hidden_widths=(16, 64),
                        activation_sets=(("relu",), ("tanh",)), epochs=2,
                        batch_size=64, seeds=(0, 1))
    accs = {}
    for n in (1, 2):
        q, rs = TaskQueue(), ResultStore()
        tasks = space.tasks("s")
        q.put_many(tasks)
        pool = WorkerPool(n, q, rs, {"datasets": {"default": dataset},
                                     "device": "cuda"})
        assert pool.run_until_empty() == len(tasks)
        assert all(d["backend"] == "cuda" and d["state"] == "stopped"
                   for d in pool.dashboard())
        docs = rs.find("s")
        assert len(docs) == len(tasks)
        assert all(d["status"] == "ok" for d in docs)
        accs[n] = {d["task_id"]: d["metrics"]["accuracy"] for d in docs}
    assert accs[1] == accs[2]


def test_worker_reports_the_cuda_backend(device):
    w = Worker("w", TaskQueue(), ResultStore(), {"device": "cuda"})
    assert w.status()["backend"] == "cuda"


def test_no_host_sync_inside_the_step_loops(device, dataset):
    """The population's and dnn_train's steps only queue work: under
    `torch.cuda.set_sync_debug_mode("error")` any operation that waits for
    the card (a loss read, a blocking copy, a stream sync) raises."""
    from repro_torch.models.dnn import dnn_loss
    from repro_torch.optim import adamw
    from repro_torch.train.step import build_dnn_train_step
    block = _block("adam")
    cfg = TP._block_config(block, dataset)
    lrs = torch.tensor([t.payload["lr"] for t in block], device=device)
    params = TP.population_params([0, 1, 2, 3], cfg, device)
    opt_init, opt_update = TP.population_optimizer("adam", lrs)
    opt = opt_init(params)
    pop_step = TP.build_population_step(cfg, opt_update)
    alive = torch.ones(len(block), dtype=torch.bool, device=device)
    single = TE.member_params(0, cfg, device)
    init, update = adamw(1e-2, weight_decay=0.0)
    single_opt = init(single)
    step = build_dnn_train_step(cfg, update, dnn_loss)
    data = TE.DeviceData(dataset, 64, 2, device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for ep in range(2):
            for batch in data.batches(ep):
                params, opt, alive, losses = pop_step(params, opt, alive,
                                                      batch)
                single, single_opt, m = step(single, single_opt, batch)
        with pytest.raises(RuntimeError):    # the mode sees a loss read
            float(losses[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(alive.all()) and math.isfinite(float(m["loss"]))
