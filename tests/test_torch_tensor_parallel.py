"""Tensor parallelism over the "model" axis (`sharding.tp`) on gloo ranks
on the CPU, f32 with TF32 off, on reduced configs (4 heads, 2 kv heads,
head_dim 64, d_ff 512, vocab 512):

- each operator on 2 and 4 ranks against one device: the column/row MLP
  (gated and not), GQA attention with qk-norm (kv heads split on 2 ranks,
  gathered on 4; and 12 heads over 3 kv heads, whose groups straddle the
  ranks), the vocab-parallel embedding, the vocab-split logits of a padded
  vocabulary, and the vocab-parallel cross-entropy with a mask, label
  smoothing and the padding. Forward and every input gradient within 1e-6
  of the one-device value's max |value| (measured: 4.9e-7);
- `train_sharded` on a (2, 2, 2) mesh, tensor parallel, for reduced
  qwen3-1.7b, starcoder2-7b and pixtral-12b, against the reference's
  `train_sharded` on its 8-device host mesh (the weights, data and
  schedule of tests/test_torch_distributed.py): losses within 1e-4
  relative, that test's bar. Step 1's gradients against one rank within
  1e-5 of each leaf's max (q_norm, k_norm and the norms included;
  measured: 2.1e-6);
- the gathered-kv path: reduced qwen3 on a ("data", "model") = (2, 4) mesh,
  where 2 kv heads do not divide 4; there also microbatches=2 and remat
  against one rank, and no rank building (B, S, V) logits.
"""
import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import _torch_tp as H  # noqa: E402
from _torch_dist import spawn  # noqa: E402
from _torch_host import one_torch_thread  # noqa: E402,F401
from repro_torch.configs import registry  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.sharding import tp as TP  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = 1e-6            # of the one-device value's max |value|
LOSS_REL = 1e-4
GRAD_TOL = 1e-5          # of each leaf's max |value|: step 1's gradients
ARCHS = ("qwen3-1.7b", "starcoder2-7b", "pixtral-12b")
STEPS, LR, LOG_EVERY = 8, 5e-3, 2

REFERENCE = r"""
import pickle, sys
import numpy as np
import jax
from jax.sharding import Mesh
import repro.launch.distributed as RD
from repro.configs import registry
from repro.data.tokens import TokenStream

out, archs = sys.argv[1], sys.argv[2].split(",")
assert jax.device_count() == 8
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2, 2),
            ("pod", "data", "model"))
init = RD.T.init_lm
for arch in archs:
    cfg = registry.get(arch, reduced=True)
    captured = []

    def record(key, c):
        p = init(key, c)
        captured.append(jax.tree.map(np.asarray, p))
        return p

    RD.T.init_lm = record
    stream = TokenStream(cfg.vocab_size, 32, 8, seed=0, branch=4)
    _, _, losses = RD.train_sharded(cfg, mesh, iter(stream), num_steps=8,
                                    lr=5e-3, log_every=2, verbose=False)
    with open(f"{out}/{arch}.pkl", "wb") as f:
        pickle.dump({"losses": [float(x) for x in losses],
                     "init": captured[0]}, f)
print("REFERENCE_OK")
"""


def close(a, b, tol, what):
    scale = max(float(b.abs().max()), 1e-30)
    err = float((a - b).abs().max())
    assert err <= tol * scale, f"{what}: {err:.3g} of {scale:.3g}"


# ------------------------------------------------------------ operators

@pytest.fixture(scope="module")
def one_device():
    return {c: H.run_operator(c, H.operator_inputs(c))
            for c in H.OPERATOR_CASES}


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def operator_runs(request, tmp_path_factory):
    world = request.param
    return world, spawn(H.operator_ranks, world,
                        tmp_path_factory.mktemp(f"ops{world}"),
                        H.OPERATOR_CASES)


# gradient of each input, by how the rank holds it: "cols"/"rows" its
# shard of the one-device gradient, "full" the whole of it (copy_to_model
# reduced it), "partial" its share of a sum over the ranks
LAYOUT = {
    "mlp_gated": {"w_gate": "cols", "w_up": "cols", "w_down": "rows",
                  "x": "full"},
    "mlp": {"w_up": "cols", "w_down": "rows", "x": "full"},
    "attention": {"wq": "cols", "wk": "kv", "wv": "kv", "wo": "rows",
                  "q_norm": "partial", "k_norm": "partial", "x": "full"},
    "embed": {"table": "rows"},
    "logits": {"table": "rows", "x": "full"},
    "xent": {"logits": "cols"},
}
LAYOUT["straddle"] = LAYOUT["attention"]
LAYOUT["xent_masked"] = LAYOUT["xent"]
OUT_LAYOUT = {"logits": "cols"}     # the others: the same on every rank


def shard(t, how, r, k):
    if how == "cols":
        n = t.shape[-1] // k
        return t[..., r * n:(r + 1) * n]
    if how == "rows":
        n = t.shape[0] // k
        return t[r * n:(r + 1) * n]
    return t


@pytest.mark.parametrize("case", H.OPERATOR_CASES)
def test_operator_matches_one_device(operator_runs, one_device, case):
    world, ranks = operator_runs
    want = one_device[case]
    for r, res in enumerate(ranks):
        got = res[case]
        close(got["out"], shard(want["out"], OUT_LAYOUT.get(case), r, world),
              OP_TOL, f"{case} rank {r} forward")
        for name, how in LAYOUT[case].items():
            if how == "kv":
                how = "cols" if got["kv_split"] else "partial"
            if how == "partial":
                continue
            close(got[f"d_{name}"], shard(want[f"d_{name}"], how, r, world),
                  OP_TOL, f"{case} rank {r} d_{name}")
    for name, how in LAYOUT[case].items():
        if how == "partial" or (how == "kv" and not ranks[0][case]["kv_split"]):
            total = sum(res[case][f"d_{name}"] for res in ranks)
            close(total, want[f"d_{name}"], OP_TOL, f"{case} d_{name} summed")


def test_kv_heads_split_on_two_ranks_gathered_on_four(operator_runs):
    world, ranks = operator_runs
    assert [r["attention"]["kv_split"] for r in ranks] == [world == 2] * world
    assert not any(r["straddle"]["kv_split"] for r in ranks)


# ------------------------------------------------------------ plans

@pytest.mark.parametrize("arch,tp,want", [
    ("qwen3-1.7b", 2, (True, True, True, True, None)),
    ("qwen3-1.7b", 16, (True, False, True, True, None)),     # 8 kv heads
    ("starcoder2-7b", 16, (False, False, True, True, None)),  # 36 heads
    ("mistral-nemo-12b", 16, (True, False, True, True, None)),
    ("pixtral-12b", 2, (True, True, True, True, None)),
    # the MoE decoder and the encoder-decoder: no dense FFN; 32 experts
    # split whole, 40 by their d_ff on 16; an odd vocabulary (49155;
    # 256206 on 16) stays whole
    ("granite-moe-1b-a400m", 2, (True, True, False, False, "expert")),
    ("seamless-m4t-large-v2", 16, (True, True, True, False, None)),
    ("granite-moe-3b-a800m", 16, (False, False, False, False, "d_ff")),
])
def test_split_plan_follows_divisibility(arch, tp, want):
    cfg = registry.get(arch)
    mesh = R.mesh_like((16 // tp if tp < 16 else 16, tp), ("data", "model"))
    ctx = TP.TensorParallel.build(cfg, mesh)      # a plan: no process group
    assert (ctx.size, ctx.heads, ctx.kv, ctx.ffn, ctx.vocab,
            ctx.experts) == (tp, *want)
    from repro_torch.launch.shapes import params_shapes
    gathered = TP.gathered_leaves(cfg, params_shapes(cfg), mesh, ctx)
    attn = ["blocks/0/attn/wq", "blocks/0/attn/wk", "blocks/0/attn/wv",
            "blocks/0/attn/wo"]
    if not want[0]:
        assert gathered == attn          # stored split by columns/rows
    elif not want[1]:
        assert gathered == attn[1:3]
    else:
        assert gathered == []


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_out_of_scope_families_stay_gathered(arch):
    """No family is out of scope since the recurrent ones split (RG-LRU
    channels, Mamba2 heads): every arch builds a context on a model axis
    of 2, and none without a model axis larger than 1."""
    cfg = registry.get(arch, reduced=True)
    assert TP.in_scope(cfg)
    assert TP.TensorParallel.build(cfg, R.mesh_like((2, 2), ("data",
                                                             "model"))) \
        is not None
    assert TP.TensorParallel.build(cfg, R.mesh_like((4, 1), ("data",
                                                             "model"))) \
        is None


@pytest.mark.parametrize("rank,tp,nh,nkv,want", [
    (1, 2, 16, 8, [4, 5, 6, 7]),      # whole groups
    (3, 16, 32, 8, [1]),              # one group shared by 2 heads
    (1, 2, 12, 3, [1, 1, 2, 2, 2, 2]),  # groups of 4 straddle the ranks
])
def test_kv_heads_of_a_rank(rank, tp, nh, nkv, want):
    cfg = registry.get("qwen3-1.7b").replace(n_heads=nh, n_kv_heads=nkv)
    mesh = SimpleNamespace(get_local_rank=lambda axis: rank)
    ctx = TP.TensorParallel(mesh, tp, True, False, True, True)
    assert ctx.rank == rank and ctx.kv_heads(cfg) == want


# ------------------------------------------------------------ training

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's train_sharded on its (2, 2, 2) host mesh for each
    arch (one subprocess): losses and initial params."""
    out = tmp_path_factory.mktemp("tp_reference")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                        ",".join(ARCHS)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-2000:]
    ref = {}
    for arch in ARCHS:
        with open(out / f"{arch}.pkl", "rb") as f:
            ref[arch] = pickle.load(f)
        ref[arch]["path"] = str(out / f"{arch}.pkl")
    return ref


@pytest.fixture(scope="module")
def tp_runs(reference, tmp_path_factory):
    """Each arch on 8 gloo ranks, a (2, 2, 2) mesh: step 1's gradients,
    then train_sharded."""
    return {arch: spawn(H.tp_train_ranks, 8,
                        tmp_path_factory.mktemp(f"tp_{arch}"), arch,
                        reference[arch]["path"], (2, 2, 2),
                        ("pod", "data", "model"), STEPS, LR, LOG_EVERY,
                        [(1, False)])
            for arch in ARCHS}


def rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_train_sharded_matches_reference(reference, tp_runs, arch):
    for r in tp_runs[arch]:
        assert r["tp"]
        assert len(r["losses"]) == STEPS // LOG_EVERY
        assert rel(r["losses"], reference[arch]["losses"]) <= LOSS_REL, \
            (r["losses"], reference[arch]["losses"])


def check_grads(got, cfg, params, microbatches=1):
    want, loss = H.one_rank_grads(cfg, params, microbatches)
    assert len(got["grads"]) == len(want)
    names = ["/".join(map(str, p)) for p in R.leaf_paths(params)]
    for name, a, b in zip(names, got["grads"], want):
        close(a, b, GRAD_TOL, name)
    assert abs(got["loss"] - loss) <= LOSS_REL * abs(loss)
    return names


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_grads_match_one_rank(reference, tp_runs, arch):
    cfg = registry.get(arch, reduced=True)
    params = H.init_params(cfg, reference[arch]["path"])
    names = check_grads(tp_runs[arch][0][(1, False)], cfg, params)
    covered = {n.split("/")[-2] for n in names if n.endswith("scale")}
    assert {"norm1", "norm2", "final_norm"} <= covered
    if cfg.qk_norm:
        assert {"q_norm", "k_norm"} <= covered


@pytest.fixture(scope="module")
def gathered_kv(reference, tmp_path_factory):
    """Reduced qwen3 on a ("data", "model") = (2, 4) mesh: microbatches 1
    and 2, remat, the op output shapes, and 8 steps."""
    return spawn(H.tp_train_ranks, 8, tmp_path_factory.mktemp("tp_kv"),
                 "qwen3-1.7b", reference["qwen3-1.7b"]["path"], (2, 4),
                 ("data", "model"), STEPS, LR, LOG_EVERY,
                 [(1, False), (2, False), (1, True), ("shapes", None)])


@pytest.mark.parametrize("variant", [(1, False), (2, False), (1, True)],
                         ids=["plain", "microbatches2", "remat"])
def test_gathered_kv_grads_match_one_rank(reference, gathered_kv, variant):
    cfg = registry.get("qwen3-1.7b", reduced=True)
    assert cfg.n_kv_heads % 4 != 0 and gathered_kv[0]["tp"]
    mb, remat = variant
    params = H.init_params(cfg.replace(remat=remat),
                           reference["qwen3-1.7b"]["path"])
    check_grads(gathered_kv[0][variant], cfg.replace(remat=remat), params,
                mb)
    for r in gathered_kv[1:]:        # every rank logs the same global loss
        assert r[variant]["loss"] == gathered_kv[0][variant]["loss"]


def test_gathered_kv_losses_match_reference(reference, gathered_kv):
    want = reference["qwen3-1.7b"]["losses"]
    for r in gathered_kv:
        assert rel(r["losses"], want) <= LOSS_REL, (r["losses"], want)


def test_no_rank_builds_full_logits(gathered_kv):
    cfg = registry.get("qwen3-1.7b", reduced=True)
    V, tp = cfg.padded_vocab_size, 4
    b, s = H.STREAM["batch"] // 2, H.STREAM["seq"]    # the rank's rows
    for r in gathered_kv:
        shapes = r["shapes"]
        assert (b, s, V // tp) in shapes         # the rank's logits
        assert not [x for x in shapes if len(x) >= 2 and x[-1] == V
                    and int(np.prod(x[:-1])) >= b * s]
        acts = [int(np.prod(x)) for x in shapes if x[:2] == (b, s)]
        assert max(acts) < b * s * V
