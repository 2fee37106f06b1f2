"""Tensor parallelism over "model" (`sharding.tp`) for the MoE decoders and
the encoder-decoder, and the MoE load-balance loss over the global batch
on a data-parallel mesh (`spmd.global_batch_mean`), on gloo ranks on the
CPU, f32 with TF32 off, on reduced configs (granite-moe-1b-a400m: 4
experts top-2, expert d_ff 128; seamless-m4t-large-v2: 2 + 2 layers, 4/2
heads, d_ff 512):

- the load balance: on the (2, 2, 2) mesh step 1's `load_balance` metric
  equals the reference's on its 8-device host mesh within 1e-6 relative,
  and on a (2, 4, 1) mesh (the gathered step, data parallel over 8
  ranks) too, where step 1's gradients, plain and under remat, match one
  rank's with the load-balance coefficient raised to 1 (at 0.01 its
  gradient is below the 1e-5 bar). Before the repair each rank took the statistic over its own
  rows and the metric was the mean of the ranks' products (4.4% off on
  four 2-row shards of reduced granite);
- the MoE FFN on 2 and 4 ranks against one device, forward and every
  input's gradient of (out * g).sum() + load balance + z-loss within 1e-6
  of the one-device value's max (measured: 3.4e-7): expert parallel
  (4 experts), each expert's d_ff split (3 experts, which 2 and 4 do not
  divide) and capacity drops (capacity factor 0.5); the one-device FFN on
  these inputs against the reference's `moe_ffn`;
- `train_sharded` on a (2, 2, 2) mesh, tensor parallel, for reduced
  granite-moe-1b (expert parallel), its 3-expert variant (per-expert
  d_ff) and reduced seamless (16 stub frames a row), against the
  reference's `train_sharded` on its 8-device host mesh: 8 steps' losses
  within 1e-4 relative. Step 1's gradients against one rank on the global
  batch within 1e-5 of each leaf's max, the router, `norm_cross` and the
  encoder's leaves among them (and microbatches=2 for granite); no rank
  holds the full (b, Ep, C, d) expert buffer;
- the split plans: `TensorParallel.build` gives a context for both
  families, and no expert or cross-attention leaf is gathered where the
  axis divides it.
"""
import dataclasses
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
from repro_torch.launch.shapes import params_shapes  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.sharding import tp as TP  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = 1e-6            # of the one-device value's max |value|
LB_REL = 1e-6            # step 1's load balance against the reference's
LOSS_REL = 1e-4
GRAD_TOL = 1e-5          # of each leaf's max |value|: step 1's gradients
CASES = ("granite-moe-1b-a400m", "granite-moe-e3", "seamless-m4t-large-v2")
MOE = CASES[:2]
STEPS, LR, LOG_EVERY = 8, 5e-3, 2

REFERENCE = r"""
import dataclasses, pickle, sys
import numpy as np
import jax
from jax.sharding import Mesh
import repro.launch.distributed as RD
from repro.configs import registry
from repro.data.tokens import TokenStream

out, cases = sys.argv[1], sys.argv[2].split(",")
assert jax.device_count() == 8
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2, 2),
            ("pod", "data", "model"))
init, make_step = RD.T.init_lm, RD.make_sharded_step


class Stream:
    # the port's tests/_torch_tp.py `stream`: tokens, and for an
    # encoder-decoder 16 stub frames a row at 0.5 from numpy's generator
    # seeded by the batch's index
    def __init__(self, cfg):
        self.cfg, self.i = cfg, 0
        self.tokens = TokenStream(cfg.vocab_size, 32, 8, seed=0, branch=4)

    def __iter__(self):
        while True:
            b = self.tokens.next_batch()
            if self.cfg.is_encdec:
                rng = np.random.default_rng(1000 + self.i)
                b["enc_embeds"] = (rng.standard_normal(
                    (8, 16, self.cfg.d_model)) * 0.5).astype(np.float32)
            self.i += 1
            yield b


for case in cases:
    arch = {"granite-moe-e3": "granite-moe-1b-a400m"}.get(case, case)
    cfg = registry.get(arch, reduced=True)
    if case == "granite-moe-e3":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=3))
    captured, metrics = [], []

    def record(key, c):
        p = init(key, c)
        captured.append(jax.tree.map(np.asarray, p))
        return p

    def recording_step(*a, **k):
        jitted, b_specs = make_step(*a, **k)

        def call(p, o, b):
            res = jitted(p, o, b)
            metrics.append({k: float(v) for k, v in res[2].items()})
            return res
        return call, b_specs

    RD.T.init_lm, RD.make_sharded_step = record, recording_step
    _, _, losses = RD.train_sharded(cfg, mesh, iter(Stream(cfg)),
                                    num_steps=8, lr=5e-3, log_every=2,
                                    verbose=False)
    with open(f"{out}/{case}.pkl", "wb") as f:
        pickle.dump({"losses": [float(x) for x in losses],
                     "metrics": metrics[0], "init": captured[0]}, f)
print("REFERENCE_OK")
"""


def close(a, b, tol, what):
    scale = max(float(b.abs().max()), 1e-30)
    err = float((a - b).abs().max())
    assert err <= tol * scale, f"{what}: {err:.3g} of {scale:.3g}"


def rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


# ------------------------------------------------------------ MoE operator

@pytest.fixture(scope="module")
def moe_one_device():
    return {c: H.run_moe(c, H.moe_inputs(c)) for c in H.MOE_CASES}


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def moe_runs(request, tmp_path_factory):
    world = request.param
    return world, spawn(H.moe_ranks, world,
                        tmp_path_factory.mktemp(f"moe{world}"), H.MOE_CASES)


@pytest.mark.parametrize("case", H.MOE_CASES)
def test_moe_operator_matches_one_device(moe_runs, moe_one_device, case):
    world, ranks = moe_runs
    want = moe_one_device[case]
    for r, res in enumerate(ranks):
        got = res[case]
        close(got["out"], want["out"], OP_TOL, f"{case} rank {r} forward")
        for k in ("load_balance", "router_z", "dropped_frac"):
            assert got[k] == want[k], (case, r, k)
        for name in ("router", "x"):      # whole on every rank
            close(got[f"d_{name}"], want[f"d_{name}"], OP_TOL,
                  f"{case} rank {r} d_{name}")
        for name in ("w_gate", "w_up", "w_down"):
            close(got[f"d_{name}"],
                  H.moe_shard(name, want[f"d_{name}"], got["split"], r,
                              world),
                  OP_TOL, f"{case} rank {r} d_{name} ({got['split']})")


def test_moe_operator_split_follows_the_rule(moe_runs, moe_one_device):
    world, ranks = moe_runs
    for res in ranks:
        assert [res[c]["split"] for c in H.MOE_CASES] == [
            "expert", "d_ff", "expert"]
    assert moe_one_device["drops"]["dropped_frac"] > 0.2


@pytest.mark.parametrize("case", H.MOE_CASES)
def test_moe_operator_one_device_matches_reference(moe_one_device, case):
    """The inputs the split is held on give the reference's FFN."""
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.models import moe as JM
    inp = H.moe_inputs(case)
    jcfg = H.family_config(case, jreg)
    out, aux = JM.moe_ffn({k: jnp.asarray(inp[k]) for k in
                           ("router", "w_gate", "w_up", "w_down")}, jcfg,
                          jnp.asarray(inp["x"]))
    want = moe_one_device[case]
    close(want["out"], torch.from_numpy(np.array(out)), 1e-5,
          f"{case} forward against the reference")
    for k in ("load_balance", "router_z"):
        assert abs(want[k] - float(aux[k])) <= 1e-5 * abs(float(aux[k])), k
    assert want["dropped_frac"] == pytest.approx(float(aux["dropped_frac"]),
                                                 abs=1e-7)


# ------------------------------------------------------------ plans

@pytest.mark.parametrize("arch,tp,experts", [
    ("granite-moe-1b-a400m", 2, "expert"),
    ("granite-moe-1b-a400m", 16, "expert"),        # 32 experts
    ("granite-moe-3b-a800m", 8, "expert"),         # 40 experts
    ("granite-moe-3b-a800m", 16, "d_ff"),          # 512 / 16 columns
    ("seamless-m4t-large-v2", 16, None),
])
def test_build_gives_a_context_and_gathers_no_split_leaf(arch, tp, experts):
    cfg = registry.get(arch)
    mesh = R.mesh_like((16 // tp if tp < 16 else 16, tp), ("data", "model"))
    ctx = TP.TensorParallel.build(cfg, mesh)
    assert TP.in_scope(cfg) and ctx is not None
    assert ctx.experts == experts
    gathered = TP.gathered_leaves(cfg, params_shapes(cfg), mesh, ctx)
    assert not [g for g in gathered
                if g.split("/")[-2] in ("ffn", "cross_attn")]
    if cfg.moe is None:
        assert gathered == [] and ctx.heads and ctx.ffn


def test_dryrun_pads_granite_3b_to_expert_parallel():
    """The dry-run pads 40 experts to 48, which 16 ranks divide."""
    from repro_torch.launch.shapes import dryrun_config
    cfg = dryrun_config(registry.get("granite-moe-3b-a800m"))
    ctx = TP.TensorParallel.build(cfg, R.mesh_like((16, 16),
                                                   ("data", "model")))
    assert cfg.moe.padded_n_experts == 48 and ctx.experts == "expert"
    rank5 = dataclasses.replace(
        ctx, mesh=SimpleNamespace(get_local_rank=lambda axis: 5))
    assert rank5.local_experts(cfg) == range(15, 18)


@pytest.mark.parametrize("path,want", [
    (("layers", 0, "ffn", "router"), ("replicate",)),
    (("layers", 0, "ffn", "w_gate"), ("shard", 0)),
    (("layers", 0, "ffn", "w_down"), ("shard", 0)),
    (("layers", 0, "cross_attn", "wq"), ("shard", 1)),
    (("layers", 0, "cross_attn", "wo"), ("shard", 0)),
    (("layers", 0, "norm_cross", "scale"), ("replicate",)),
    (("encoder", "layers", 1, "attn", "wk"), ("shard", 1)),
    (("encoder", "layers", 1, "ffn", "w_down"), ("shard", 0)),
    (("encoder", "final_norm", "scale"), ("replicate",)),
])
def test_roles_of_the_family_leaves(path, want):
    arch = ("granite-moe-1b-a400m" if "router" in path or
            (path[0] == "layers" and path[2] == "ffn")
            else "seamless-m4t-large-v2")
    ctx = TP.TensorParallel.build(registry.get(arch),
                                  R.mesh_like((2, 2), ("data", "model")))
    assert ctx.role(path) == want


def test_per_expert_roles():
    cfg = registry.get("granite-moe-3b-a800m")
    ctx = TP.TensorParallel.build(cfg, R.mesh_like((1, 16),
                                                   ("data", "model")))
    assert [ctx.role(("layers", 0, "ffn", n)) for n in
            ("router", "w_gate", "w_up", "w_down")] == [
        ("replicate",), ("shard", 2), ("shard", 2), ("shard", 1)]


# ------------------------------------------------------------ training

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's train_sharded on its (2, 2, 2) host mesh for each
    case (one subprocess): losses, step 1's metrics and initial params."""
    out = tmp_path_factory.mktemp("tp_family_reference")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                        ",".join(CASES)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-2000:]
    ref = {}
    for case in CASES:
        with open(out / f"{case}.pkl", "rb") as f:
            ref[case] = pickle.load(f)
        ref[case]["path"] = str(out / f"{case}.pkl")
    return ref


def variants(case):
    """Step 1 plain; for granite also microbatches=2 and the op shapes."""
    if case == CASES[0]:
        return [(1, False), (2, False), (1, True), ("shapes", None)]
    return [(1, False)]


@pytest.fixture(scope="module")
def tp_runs(reference, tmp_path_factory):
    """Each case on 8 gloo ranks, a (2, 2, 2) mesh: step 1's gradients
    and metrics, then train_sharded."""
    return {case: spawn(H.tp_train_ranks, 8,
                        tmp_path_factory.mktemp(f"tpf_{case}"), case,
                        reference[case]["path"], (2, 2, 2),
                        ("pod", "data", "model"), STEPS, LR, LOG_EVERY,
                        variants(case))
            for case in CASES}


@pytest.fixture(scope="module")
def data_parallel_run(reference, tmp_path_factory):
    """Reduced granite, its load-balance coefficient raised to 1, on a
    ("pod", "data", "model") = (2, 4, 1) mesh (the model axis of 1: the
    gathered step): step 1 only, plain and under remat."""
    return spawn(H.tp_train_ranks, 8, tmp_path_factory.mktemp("dp_moe"),
                 "granite-moe-lb", reference[CASES[0]]["path"], (2, 4, 1),
                 ("pod", "data", "model"), 0, LR, LOG_EVERY,
                 [(1, False), (1, True)])


@pytest.mark.parametrize("case", MOE)
def test_load_balance_is_the_global_batch_statistic(reference, tp_runs,
                                                    case):
    want = reference[case]["metrics"]["load_balance"]
    for r in tp_runs[case]:
        got = r[(1, False)]["metrics"]["load_balance"]
        assert abs(got - want) <= LB_REL * abs(want), (got, want)
        for k in ("router_z", "dropped_frac"):
            assert abs(r[(1, False)]["metrics"][k]
                       - reference[case]["metrics"][k]) <= 1e-6, k


def test_load_balance_on_a_data_parallel_mesh(reference, data_parallel_run):
    want = reference[CASES[0]]["metrics"]["load_balance"]
    for r in data_parallel_run:
        assert not r["tp"]
        got = r[(1, False)]["metrics"]["load_balance"]
        assert abs(got - want) <= LB_REL * abs(want), (got, want)


@pytest.mark.parametrize("case", CASES)
def test_family_train_sharded_matches_reference(reference, tp_runs, case):
    for r in tp_runs[case]:
        assert r["tp"]
        assert len(r["losses"]) == STEPS // LOG_EVERY
        assert rel(r["losses"], reference[case]["losses"]) <= LOSS_REL, \
            (r["losses"], reference[case]["losses"])


def check_grads(got, cfg, params, microbatches=1):
    want, loss = H.one_rank_grads(cfg, params, microbatches)
    assert len(got["grads"]) == len(want)
    names = ["/".join(map(str, p)) for p in R.leaf_paths(params)]
    for name, a, b in zip(names, got["grads"], want):
        close(a, b, GRAD_TOL, name)
    assert abs(got["loss"] - loss) <= LOSS_REL * abs(loss)
    return names


@pytest.mark.parametrize("case", CASES)
def test_family_step_grads_match_one_rank(reference, tp_runs, case):
    cfg = H.family_config(case)
    params = H.init_params(cfg, reference[case]["path"])
    names = check_grads(tp_runs[case][0][(1, False)], cfg, params)
    if cfg.moe:
        assert any(n.endswith("ffn/router") for n in names)
    else:
        assert any(n.endswith("norm_cross/scale") for n in names)
        assert any(n.startswith("encoder/layers/") for n in names)
        assert "encoder/final_norm/scale" in names


@pytest.mark.parametrize("variant", [(2, False), (1, True)],
                         ids=["microbatches2", "remat"])
def test_granite_variant_grads_match_one_rank(reference, tp_runs, variant):
    """Microbatches: the statistic over each global microbatch's rows;
    remat: the recomputed forward reduces over the batch axes again."""
    mb, remat = variant
    cfg = H.family_config(CASES[0]).replace(remat=remat)
    params = H.init_params(cfg, reference[CASES[0]]["path"])
    check_grads(tp_runs[CASES[0]][0][variant], cfg, params, mb)


@pytest.mark.parametrize("variant", [(1, False), (1, True)],
                         ids=["plain", "remat"])
def test_data_parallel_grads_match_one_rank(reference, data_parallel_run,
                                            variant):
    """The router's gradient carries the global batch's load balance
    (the all-reduce's backward sums every rank's share), under remat
    too."""
    cfg = H.family_config("granite-moe-lb").replace(remat=variant[1])
    params = H.init_params(cfg, reference[CASES[0]]["path"])
    check_grads(data_parallel_run[0][variant], cfg, params)


@pytest.mark.parametrize("variant", [(1, False), (1, True)],
                         ids=["plain", "remat"])
def test_load_balance_all_reduces_per_layer(data_parallel_run, variant):
    """The means' all-reduce over the batch dims runs forward and backward
    once per MoE layer; under remat the recomputed layer runs it again:
    the groups are an argument of the checkpointed block, so the
    recompute has them on whatever thread the backward runs."""
    cfg = H.family_config("granite-moe-lb")
    want = (3 if variant[1] else 2) * cfg.n_layers
    for r in data_parallel_run:
        assert r[variant]["batch_reduces"] == want


def test_no_rank_holds_the_full_expert_buffer(tp_runs):
    cfg = H.family_config(CASES[0])
    m = cfg.moe
    b, s, tp = H.STREAM["batch"] // 4, H.STREAM["seq"], 2
    C = int(max(m.top_k, round(s * m.top_k * m.capacity_factor
                                / m.n_experts)))
    for r in tp_runs[CASES[0]]:
        shapes = r["shapes"]
        assert (b, m.padded_n_experts // tp, C, cfg.d_model) in shapes
        assert (b, m.padded_n_experts, C, cfg.d_model) not in shapes
