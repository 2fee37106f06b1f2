"""The serving steps tensor parallel over "model" (`serve.step.build_prefill`
/ `build_decode` with `tp`, run by `sharding.spmd.call_split`) for the
attention families, on gloo ranks on the CPU, f32 with TF32 off, on
reduced configs (4 heads, 2 kv heads, head_dim 64, 2 layers; seamless 2 +
2 layers), with the decode caches' sequence split over "model"
(`rules.cache_specs`, the reference's flash-decoding layout):

- the decode read (`layers.attention_decode` with `tp`: the token's
  queries, keys and values gathered, the owner of slot pos % Sc writing,
  every rank reading all heads over its slots, the partials merged) on 2
  and 4 ranks against one device's `attention_decode`: output within 1e-6
  of its max, the written caches equal, for a full cache, a ring under a
  window, a rank whose slice is all empty, `rows=` a subset, a length
  neither divides (the read runs whole, no merge) and a cross read; the
  all-reduces of each exactly (3 with a split cache; 2 whole where the kv
  heads split and 1 where they are gathered on 4 ranks);
- the dense decoders' prefill, `prefill_into_cache_split` into 48
  decode slots (24 a rank) and 8 greedy decode steps on a (1, 1, 2) mesh,
  and reduced qwen3 on (1, 1, 4), where its 2 kv heads are gathered: the
  tokens equal the reference's own `build_prefill` / `build_decode` on one
  device on the same bridged weights (the reference's 8-device mesh path
  fails on jax 0.9.0: ROADMAP Queue 3, reference item 6); the logits of
  every step within 1e-5 of the port's one-device step's max; the
  prefill caches, the handed decode caches and the final caches gathered
  equal the one-device caches within 1e-5 of their max (positions
  exactly); the prefill caches' move to head_dim by the all-reduce route
  (the card rig's) equal the all-to-all's; the all-reduces and
  all-to-alls of every call exactly (below); no rank holding a layer's
  full-length cache or a full (B, V) row of logits in a greedy step or
  the handoff. Dense decoders here; the MoE decoders, the
  encoder-decoder and the (2, 2, 2) mesh:
  tests/test_torch_tensor_parallel_serving_families.py; the recurrent
  families: tests/test_torch_tensor_parallel_serving_recurrent.py.

The all-reduce counts: tests/_torch_tp_serving.py.
"""
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import _torch_tp as H  # noqa: E402
import _torch_tp_serving as SV  # noqa: E402
from _torch_dist import spawn  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.configs import registry  # noqa: E402

OP_TOL = 1e-6            # of the one-device value's max |value|
close = SV.close
DENSE = ("qwen3-1.7b", "qwen3-4b", "mistral-nemo-12b", "starcoder2-7b",
         "pixtral-12b")
FAMILIES = ("granite-moe-1b-a400m", "granite-moe-3b-a800m",
            "seamless-m4t-large-v2")
MESHES = {"1x1x2": ((1, 1, 2), DENSE), "1x1x4": ((1, 1, 4), DENSE[:1])}


# ------------------------------------------------------------ the read

@pytest.fixture(scope="module")
def read_one_device():
    return {c: H.run_read(c, H.read_inputs(c)) for c in H.READ_CASES}


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def read_runs(request, tmp_path_factory):
    world = request.param
    return world, spawn(H.read_ranks, world,
                        tmp_path_factory.mktemp(f"read{world}"),
                        H.READ_CASES)


@pytest.mark.parametrize("case", H.READ_CASES)
def test_decode_read_matches_one_device(read_runs, read_one_device, case):
    world, ranks = read_runs
    want = read_one_device[case]
    n = H.READ_SHAPES[case][0]
    assert all(r[case]["split"] == (n % world == 0) for r in ranks)
    for r, res in enumerate(ranks):
        close(res[case]["out"], want["out"], OP_TOL,
              f"{case} rank {r} of {world}")
    for name in ("k", "v", "pos"):
        got = [res[case][name] for res in ranks]
        got = torch.cat(got, dim=1) if ranks[0][case]["split"] else got
        for g in ([got] if ranks[0][case]["split"] else got):
            if name == "pos":
                assert torch.equal(g, want[name]), (case, world)
            else:
                close(g, want[name], OP_TOL, f"{case} {name} of {world}")


def test_decode_read_all_reduces(read_runs):
    """Split: the token's q (k, v) gathered, the partials merged, the
    output; whole: k and v gathered where the kv heads split (2 ranks),
    nothing where every rank projects them all (4), then the output."""
    world, ranks = read_runs
    for res in ranks:
        for case in H.READ_CASES:
            split = res[case]["split"]
            want = 3 if split else (2 if res[case]["kv"] else 1)
            assert res[case]["all_reduces"] == want, (case, world)
    assert [r["ring"]["kv"] for r in ranks] == [world == 2] * world


def test_an_empty_slice_adds_nothing(read_runs, read_one_device):
    """Every slot past 8 is empty: on 4 ranks three of them hold no valid
    slot, and the merged read is still the one-device read."""
    world, ranks = read_runs
    pos = [res["empty_rank"]["pos"] for res in ranks]
    assert all(bool((p < 0).all()) for p in pos[1:])
    for res in ranks:
        close(res["empty_rank"]["out"], read_one_device["empty_rank"]["out"],
              OP_TOL, "empty slices")


# ------------------------------------------------------------ the archs

@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    return SV.bridged_params(DENSE, tmp_path_factory)


@pytest.fixture(scope="module")
def one_device(bridged):
    return SV.one_device_runs(bridged[0])


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_runs(request, bridged, tmp_path_factory):
    shape, archs = MESHES[request.param]
    return SV.mesh_run(shape, archs, bridged[1],
                       tmp_path_factory.mktemp(request.param))


@pytest.mark.parametrize("arch", DENSE)
def test_one_device_tokens_match_the_reference(one_device, arch):
    SV.check_one_device_tokens(one_device, arch)


def test_tokens_match_the_reference(mesh_runs):
    SV.check_tokens(mesh_runs)


def test_logits_match_one_device(mesh_runs, one_device):
    SV.check_logits(mesh_runs, one_device)


def test_caches_match_one_device(mesh_runs, one_device):
    SV.check_caches(mesh_runs, one_device)


def test_all_reduce_counts(mesh_runs):
    SV.check_counts(mesh_runs)


def test_no_rank_holds_a_full_cache_or_logits_row(mesh_runs):
    SV.check_no_full_cache_or_logits(mesh_runs)


def test_serving_split_plans():
    """`TensorParallel.build` splits the serving steps of every arch, the
    attention families and the recurrent ones alike (the serving shapes
    of `launch.shapes.make_case` build it for every case)."""
    from repro_torch.launch import shapes as S
    from repro_torch.sharding import rules as R
    from repro_torch.sharding import tp as TP
    mesh = R.mesh_like((16, 16), ("data", "model"))
    for arch in registry.ARCH_IDS:
        cfg = registry.get(arch)
        assert TP.in_scope(cfg), arch
        assert TP.TensorParallel.build(cfg, mesh) is not None
        assert S.make_case(cfg, "decode_32k", mesh)["tp"] is not None, arch


def test_cache_split_follows_the_rule():
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules as R
    from repro_torch.sharding import tp as TP
    cfg = registry.get("seamless-m4t-large-v2", reduced=True)
    mesh = R.mesh_like((1, 2), ("data", "model"))
    for n, enc, want in ((48, 16, (True, True)), (47, 16, (False, True)),
                         (48, 15, (True, False))):
        cache = T.init_cache(cfg, 4, n, device="meta", enc_len=enc)
        assert TP.cache_split(R.cache_specs(cfg, cache, mesh)) == want
