"""Tensor parallelism over "model" (`sharding.tp`) for the recurrent
families, on gloo ranks on the CPU, f32 with TF32 off, on reduced configs
(recurrentgemma-9b: r, r, a; lru width 256, 4/1 heads, d_ff 512;
mamba2-130m: 2 layers, 16 heads of 32, d_state 32, one group):

- the two new operators on 2 and 4 ranks against one device, forward and
  backward, within 1e-6 of the one-device value's max: `gather_from_model`
  (each rank's products read the whole width, so its backward all-reduces
  before it slices; and, as `spmd.split_params` gathers a leaf stored
  split that every rank uses whole, by rows with no reduction) and the
  gated RMSNorm split over its width (the sum of
  squares through `sum_over_model`: with an identity backward each rank's
  gradient would miss the other ranks' share of the norm);
- the RG-LRU block and the Mamba2 block (one group, and two groups of 8
  heads) on 2 and 4 ranks against one device, forward and every leaf's
  gradient within 1e-5 of the one-device value's max (measured: 3.7e-6,
  the A_log gradient on 4 ranks; the split sums in another f32 order, the
  norm's and out_proj's partial sums over the ranks among them); the
  one-device blocks on these inputs against the reference's;
- `train_sharded` on a (2, 2, 2) mesh, tensor parallel, for reduced
  recurrentgemma-9b and reduced mamba2-130m against the reference's
  `train_sharded` on its 8-device host mesh: 8 steps' losses within 1e-4
  relative. Reduced mamba2's `in_proj` (1,104 columns) is stored split at
  column 552, inside x, so its step exercises the per-segment slicing of
  a gathered leaf. Step 1's gradients against one rank on the global
  batch within 1e-5 of each leaf's max, and for recurrentgemma with
  microbatches 2 and under remat too;
- the split plans: `TensorParallel.build` gives a context for both
  families on every mesh with a model axis, the RG-LRU width and the SSM
  heads split where the axis divides them, and the roles of their leaves.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

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
OP_TOL = 1e-6            # the operators, of the one-device value's max
BLOCK_TOL = 1e-5         # the blocks, of the one-device value's max
LOSS_REL = 1e-4
GRAD_TOL = 1e-5          # of each leaf's max |value|: step 1's gradients
ARCHS = ("recurrentgemma-9b", "mamba2-130m")
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


def rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


# ------------------------------------------------------------ operators

@pytest.fixture(scope="module")
def one_device():
    return {c: H.run_recurrent(c, H.recurrent_inputs(c))
            for c in H.RECURRENT_CASES}


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def recurrent_runs(request, tmp_path_factory):
    world = request.param
    return world, spawn(H.recurrent_ranks, world,
                        tmp_path_factory.mktemp(f"rec{world}"),
                        H.RECURRENT_CASES)


def test_gather_from_model_matches_one_device(recurrent_runs, one_device):
    """Forward: the whole width on every rank. Backward: rank r's products
    took g rolled by r, so its slice of x gets its slice of the sum of
    every rank's roll."""
    world, ranks = recurrent_runs
    want = one_device["gather"]
    g = torch.from_numpy(H.recurrent_inputs("gather")["g"])
    total = sum(torch.roll(g, j, dims=-1) for j in range(world))
    for r, res in enumerate(ranks):
        got = res["gather"]
        close(got["out"], want["out"], OP_TOL, f"rank {r} forward")
        close(got["d_x"], H.lay(total, "cols", r, world), OP_TOL,
              f"rank {r} d_x")


@pytest.mark.parametrize("case", H.RECURRENT_CASES[1:])
def test_recurrent_operator_matches_one_device(recurrent_runs, one_device,
                                               case):
    world, ranks = recurrent_runs
    want = one_device[case]
    tol = OP_TOL if case in ("gather_rows", "norm") else BLOCK_TOL
    for r, res in enumerate(ranks):
        got = res[case]
        close(got["out"], H.lay(want["out"], H.RECURRENT_OUT.get(case),
                                r, world), tol, f"{case} rank {r} forward")
        for name, how in H.RECURRENT_LAYOUT[case].items():
            if how != "partial":
                close(got[f"d_{name}"], H.lay(want[f"d_{name}"], how, r,
                                              world),
                      tol, f"{case} rank {r} d_{name}")
    for name, how in H.RECURRENT_LAYOUT[case].items():
        if how == "partial":
            total = sum(res[case][f"d_{name}"] for res in ranks)
            close(total, want[f"d_{name}"], tol, f"{case} d_{name} summed")


def test_recurrent_parts_split(recurrent_runs):
    """The RG-LRU width (256) and the SSM heads (16) split on 2 and 4."""
    world, ranks = recurrent_runs
    for res in ranks:
        assert res["rglru"]["split"] == (True, False)
        assert res["mamba2"]["split"] == res["mamba2_g2"]["split"] \
            == (False, True)


@pytest.mark.parametrize("case", ["rglru", "mamba2", "mamba2_g2"])
def test_one_device_block_matches_reference(one_device, case):
    """The inputs the split is held on give the reference's block."""
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.models import mamba2 as JM
    from repro.models import rglru as JR
    inp = H.recurrent_inputs(case)
    arch = "recurrentgemma-9b" if case == "rglru" else "mamba2-130m"
    jcfg = jreg.get(arch, reduced=True)
    tcfg = H.recurrent_config(case)
    if case == "mamba2_g2":
        jcfg = jcfg.replace(ssm=dataclasses.replace(
            jcfg.ssm, n_groups=tcfg.ssm.n_groups))
    p = {k: jnp.asarray(v) for k, v in inp.items() if k not in ("x", "g")}
    block = JR.rglru_block_forward if case == "rglru" else JM.mamba2_forward
    out, _ = block(p, jcfg, jnp.asarray(inp["x"]))
    close(one_device[case]["out"], torch.from_numpy(np.array(out)), 1e-5,
          f"{case} forward against the reference")


# ------------------------------------------------------------ plans

@pytest.mark.parametrize("arch,tp,lru,ssm,heads,kv", [
    ("recurrentgemma-9b", 2, True, False, True, False),   # 16 / 1 heads
    ("recurrentgemma-9b", 16, True, False, True, False),  # lru 4096 / 16
    ("mamba2-130m", 2, False, True, True, True),          # 24 SSM heads
    ("mamba2-130m", 8, False, True, True, True),
    ("mamba2-130m", 16, False, False, True, True),        # 24 % 16: whole
])
def test_recurrent_split_plan(arch, tp, lru, ssm, heads, kv):
    cfg = registry.get(arch)
    mesh = R.mesh_like((16 // tp if tp < 16 else 16, tp), ("data", "model"))
    ctx = TP.TensorParallel.build(cfg, mesh)
    assert TP.in_scope(cfg) and ctx is not None
    assert (ctx.lru, ctx.ssm, ctx.heads, ctx.kv) == (lru, ssm, heads, kv)


@pytest.mark.parametrize("path,want", [
    (("layers", 0, "rglru", "w_x"), ("shard", 1)),
    (("layers", 0, "rglru", "w_r"), ("shard", 1)),
    (("layers", 0, "rglru", "conv_w"), ("shard", 1)),
    (("layers", 0, "rglru", "out_proj"), ("shard", 0)),
    (("layers", 0, "rglru", "Lambda"), ("partial",)),
    (("layers", 0, "rglru", "conv_b"), ("partial",)),
    (("layers", 2, "attn", "wk"), ("partial",)),          # 1 kv head
    (("layers", 0, "mamba", "in_proj"), ("partial",)),
    (("layers", 0, "mamba", "conv_w"), ("partial",)),
    (("layers", 0, "mamba", "norm_scale"), ("partial",)),
    (("layers", 0, "mamba", "out_proj"), ("shard", 0)),
    (("layers", 0, "norm1", "scale"), ("replicate",)),
])
def test_roles_of_the_recurrent_leaves(path, want):
    arch = "mamba2-130m" if "mamba" in path else "recurrentgemma-9b"
    ctx = TP.TensorParallel.build(registry.get(arch),
                                  R.mesh_like((2, 2), ("data", "model")))
    assert ctx.role(path) == want


def test_mamba2_on_16_ranks_gathers_its_blocks():
    """24 heads do not divide 16: every Mamba2 leaf is taken gathered and
    used whole; the vocabulary, padded by the dry-run to 50,432, still
    splits."""
    from repro_torch.launch.shapes import dryrun_config
    cfg = dryrun_config(registry.get("mamba2-130m"))
    ctx = TP.TensorParallel.build(cfg, R.mesh_like((16, 16),
                                                   ("data", "model")))
    assert ctx.role(("layers", 3, "mamba", "out_proj")) == ("replicate",)
    assert ctx.role(("embed", "table")) == ("shard", 0)


@pytest.mark.parametrize("first,n_local,rep,want", [
    (8, 8, 8, [1]),           # a rank's heads: one whole group
    (4, 4, 8, [0]),           # two ranks share a group
    (0, 8, 4, [0, 1]),        # two whole groups
    (4, 4, 16, [0]),          # one group for every head
])
def test_head_groups(first, n_local, rep, want):
    assert TP.head_groups(first, n_local, rep) == want


# ------------------------------------------------------------ training

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's train_sharded on its (2, 2, 2) host mesh for each
    arch (one subprocess): losses and initial params."""
    out = tmp_path_factory.mktemp("tp_recurrent_reference")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                        ",".join(ARCHS)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-2000:]
    ref = {}
    for arch in ARCHS:
        with open(out / f"{arch}.pkl", "rb") as f:
            ref[arch] = pickle.load(f)
        ref[arch]["path"] = str(out / f"{arch}.pkl")
    return ref


def variants(arch):
    """Step 1 plain; for recurrentgemma also microbatches=2 and remat."""
    if arch == ARCHS[0]:
        return [(1, False), (2, False), (1, True)]
    return [(1, False)]


@pytest.fixture(scope="module")
def tp_runs(reference, tmp_path_factory):
    """Each arch on 8 gloo ranks, a (2, 2, 2) mesh: step 1's gradients,
    then train_sharded."""
    return {arch: spawn(H.tp_train_ranks, 8,
                        tmp_path_factory.mktemp(f"tpr_{arch}"), arch,
                        reference[arch]["path"], (2, 2, 2),
                        ("pod", "data", "model"), STEPS, LR, LOG_EVERY,
                        variants(arch))
            for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_train_sharded_matches_reference(reference, tp_runs,
                                                   arch):
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
def test_recurrent_step_grads_match_one_rank(reference, tp_runs, arch):
    cfg = registry.get(arch, reduced=True)
    params = H.init_params(cfg, reference[arch]["path"])
    names = check_grads(tp_runs[arch][0][(1, False)], cfg, params)
    mixer = "rglru" if cfg.rglru else "mamba"
    assert any(n.endswith(f"{mixer}/out_proj") for n in names)


@pytest.mark.parametrize("variant", [(2, False), (1, True)],
                         ids=["microbatches2", "remat"])
def test_recurrentgemma_variant_grads_match_one_rank(reference, tp_runs,
                                                     variant):
    mb, remat = variant
    cfg = registry.get(ARCHS[0], reduced=True).replace(remat=remat)
    params = H.init_params(cfg, reference[ARCHS[0]]["path"])
    check_grads(tp_runs[ARCHS[0]][0][variant], cfg, params, mb)
    for r in tp_runs[ARCHS[0]][1:]:    # every rank logs the same loss
        assert r[variant]["loss"] == tp_runs[ARCHS[0]][0][variant]["loss"]
