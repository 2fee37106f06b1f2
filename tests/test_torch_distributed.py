"""The port's distribution on gloo ranks on the CPU: sharded training
(`launch.distributed.train_sharded` on DTensor leaves) against the
reference's `train_sharded` on its 8-device host mesh and against the
port's own one-rank step, the population block sharded over a mesh, and
checkpoints written and restored on ranks.

The reference runs in a subprocess with 8 XLA host devices on a
`jax.sharding.Mesh` built by hand ((2, 2, 2), "pod"/"data"/"model"; its
`make_debug_mesh` fails on jax 0.9.0, ROADMAP Queue 3 reference item 6),
on the script of tests/test_distributed.py: reduced qwen3-1.7b,
`TokenStream(V, 32, 8, seed=0, branch=4)`, 8 steps, lr 5e-3, the loss
logged every 2 steps. It saves its initial params, which every rank of the
port starts from (`T.init_lm` patched), and a checkpoint of them.

Tolerances: losses within 1e-4 relative, against the reference and
against one rank (partial sums over two mesh axes reduce in another order
than one batch's). The (2, 2, 2) mesh runs reduced qwen3-1.7b tensor
parallel over "model" (`sharding.tp`). The first step's gradients
against one rank: within 1e-5 of each leaf's max |value| (measured:
9.3e-7). Params against one rank after 8 AdamW steps at lr 5e-3: within
5e-3 of each leaf's max (measured: 2.3e-3 with one microbatch, 2.6e-3
with two; 5.8e-4 and 3.2e-3 when the step gathered the params). An AdamW step moves an element by up to the learning
rate whatever its gradient's size, so an element whose gradient is near
zero turns the reduction order's last-bit differences into a visible step,
and 8 steps at this rate compound them; the losses stay within 1e-6.
Population: losses 1e-5 relative, params 1e-5 of each leaf's max (each
rank runs its members' own arithmetic).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from _torch_dist import (checkpoint_ranks, population_ranks,  # noqa: E402
                         spawn, train_ranks)
from _torch_host import one_torch_thread  # noqa: E402,F401
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedules import linear_warmup_cosine  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.train.step import build_lm_train_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, STEPS, LR, LOG_EVERY = "qwen3-1.7b", 8, 5e-3, 2
LOSS_REL = 1e-4
GRAD_TOL = 1e-5          # of each leaf's max |value|: step 1's gradients
PARAM_TOL = 5e-3         # of each leaf's max |value|: after 8 AdamW steps
POP_REL, POP_TOL = 1e-5, 1e-5

REFERENCE = r"""
import pickle, sys
import numpy as np
import jax
from jax.sharding import Mesh
import repro.launch.distributed as RD
from repro.checkpoint.checkpoint import save_checkpoint
from repro.configs import registry
from repro.data.tokens import TokenStream

out = sys.argv[1]
assert jax.device_count() == 8
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2, 2),
            ("pod", "data", "model"))
cfg = registry.get("qwen3-1.7b", reduced=True)
init, captured = RD.T.init_lm, []


def record(key, c):
    p = init(key, c)
    captured.append(jax.tree.map(np.asarray, p))
    return p


RD.T.init_lm = record
stream = TokenStream(cfg.vocab_size, 32, 8, seed=0, branch=4)
params, opt, losses = RD.train_sharded(cfg, mesh, iter(stream), num_steps=8,
                                       lr=5e-3, log_every=2, verbose=False)
shards = {s.data.shape for s in params["embed"]["table"].addressable_shards}
assert any(s != params["embed"]["table"].shape for s in shards)
with open(out + "/ref.pkl", "wb") as f:
    pickle.dump({"losses": [float(x) for x in losses],
                 "init": captured[0]}, f)
save_checkpoint(out + "/ckpt", 0, captured[0])
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out)], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-2000:]
    with open(out / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    ref["dir"] = out
    return ref


@pytest.fixture(scope="module")
def sharded(reference, tmp_path_factory):
    """The port on 8 gloo ranks, microbatches 1 and 2."""
    tmp = tmp_path_factory.mktemp("sharded")
    return spawn(train_ranks, 8, tmp, str(reference["dir"] / "ref.pkl"),
                 ARCH, STEPS, LR, LOG_EVERY, (1, 2))


def one_rank(reference, microbatches):
    """The same run on one rank: the unsharded step under train_sharded's
    schedule, from the same params, on the same batches. Returns (logged
    losses, final params, the first step's gradients)."""
    cfg = registry.get(ARCH, reduced=True)
    params = params_from_jax(reference["init"], cfg, device="cpu")
    grads = []

    def record(g, state, p):
        grads.extend(tree_leaves(g))
        return p, state, {}
    first = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             TokenStream(cfg.vocab_size, 32, 8, seed=0, branch=4)
             .next_batch().items()}
    build_lm_train_step(cfg, record, microbatches=microbatches)(
        params, None, first)
    opt_init, opt_update = adamw(linear_warmup_cosine(
        LR, max(STEPS // 10, 1), STEPS))
    opt = opt_init(params)
    step = build_lm_train_step(cfg, opt_update, microbatches=microbatches)
    stream = iter(TokenStream(cfg.vocab_size, 32, 8, seed=0, branch=4))
    losses = []
    for s in range(1, STEPS + 1):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in next(stream).items()}
        params, opt, m = step(params, opt, batch)
        if s % LOG_EVERY == 0:
            losses.append(float(m["loss"]))
    return losses, params, grads


def rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def test_sharded_losses_match_reference(reference, sharded):
    for r in sharded:
        assert len(r[1]["losses"]) == STEPS // LOG_EVERY
        assert rel(r[1]["losses"], reference["losses"]) <= LOSS_REL, \
            (r[1]["losses"], reference["losses"])


def test_embed_table_sharded_over_model(sharded):
    r = sharded[0][1]
    assert r["embed_local"] != r["embed_global"]
    assert r["embed_local"][0] * 2 == r["embed_global"][0]
    assert r["embed_placements"] == [("Replicate", None),
                                     ("Replicate", None), ("Shard", 0)]
    assert all(x[mb]["moments_like_params"] for x in sharded
               for mb in (1, 2))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_sharded_matches_one_rank(reference, sharded, microbatches):
    losses, params, grads = one_rank(reference, microbatches)
    got = sharded[0][microbatches]
    assert len(got["grads"]) == len(grads)
    for a, b in zip(got["grads"], grads):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= GRAD_TOL * max(scale, 1e-30)
    assert rel(got["losses"], losses) <= LOSS_REL, (got["losses"], losses)
    for r in sharded[1:]:      # every rank logs the same global loss
        assert r[microbatches]["losses"] == got["losses"]
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(params)):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= PARAM_TOL * max(scale, 1e-30)


# ------------------------------------------------------------ population

@pytest.fixture(scope="module")
def pop_case():
    from repro_torch.core.tasks import TaskSpec
    from repro_torch.data import pipeline, synthetic
    ds = pipeline.prepare(synthetic.classification_csv(400, 6, 3, seed=2),
                          "label")
    block = [TaskSpec.make("pop", "dnn_train", {
        "hidden_sizes": [16], "activations": ["relu"], "lr": lr,
        "optimizer": opt, "epochs": 2, "batch_size": 64, "seed": s})
        for s, (opt, lr) in enumerate([("adam", 1e-2), ("adam", 3e-3)] * 4)]
    return block, {"datasets": {"default": ds}, "device": "cpu"}


@pytest.fixture(scope="module")
def unsharded_population(pop_case):
    from repro_torch.core import population as TP
    block, ctx = pop_case
    drawn = []
    draw = TP.population_params

    def record(*a):
        drawn.append(draw(*a))
        return drawn[-1]
    TP.population_params = record
    try:
        docs = TP.train_population(block, ctx)
    finally:
        TP.population_params = draw
    return docs, drawn[0]


@pytest.mark.parametrize("world", [2, 4])
def test_population_on_a_mesh_matches_unsharded(pop_case,
                                                 unsharded_population,
                                                 world, tmp_path):
    block, ctx = pop_case
    want_docs, want_params = unsharded_population
    for docs, params in spawn(population_ranks, world, tmp_path, block,
                              ctx):
        assert [d["status"] for d in docs] == \
            [d["status"] for d in want_docs]
        for d, w in zip(docs, want_docs):
            a, b = d["metrics"]["final_loss"], w["metrics"]["final_loss"]
            assert abs(a - b) <= POP_REL * abs(b)
            assert d["metrics"]["accuracy"] == w["metrics"]["accuracy"]
            assert d["metrics"]["population_size"] == len(block)
        for a, b in zip(tree_leaves(params), tree_leaves(want_params)):
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= POP_TOL * scale


def test_population_mesh_must_divide_the_block(pop_case):
    from repro_torch.core import population as TP
    from repro_torch.sharding import rules as R
    block, ctx = pop_case
    with pytest.raises(ValueError, match="does not divide"):
        TP.train_population(block[:6], ctx,
                            mesh=R.mesh_like((4,), ("data",)))


# ------------------------------------------------------------ checkpoints

def test_checkpoints_on_ranks(reference, tmp_path):
    ckpt = tmp_path / "ckpt"
    got = spawn(checkpoint_ranks, 2, tmp_path, str(ckpt),
                str(reference["dir"] / "ckpt"), ARCH)
    assert sorted(os.listdir(ckpt)) == ["step_00000003.manifest.json",
                                        "step_00000003.proc0.npz",
                                        "step_00000003.proc1.npz"]
    for rank, r in enumerate(got):
        assert r["process_index"] == rank
        assert r["path"] == f"step_00000003.proc{rank}.npz"
        assert r["same"] and all(p and v for _, p, v in r["same"])
        assert any(("Shard", 0) in p or ("Shard", 1) in p
                   for p in r["ref_placements"])
    # the reference's file (one process) restored onto the mesh: values
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            reference["init"])[0]:
        flat["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path)] = leaf
    mine = got[0]["ref_full"]
    from repro_torch.sharding.rules import _walk
    n = 0
    for path, leaf in _walk(mine):
        if not isinstance(leaf, torch.Tensor):      # the empty tail
            continue
        key = "/".join(str(p) for p in path)
        np.testing.assert_array_equal(leaf.numpy(), flat[key])
        n += 1
    assert n == len(flat)
