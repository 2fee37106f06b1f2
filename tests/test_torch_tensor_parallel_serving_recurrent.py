"""The serving steps tensor parallel over "model" for the recurrent
families (recurrentgemma-9b, mamba2-130m), on gloo ranks on the CPU, f32
with TF32 off, reduced configs, their decode states whole on every rank
(the reference's batch-only layout, `rules.cache_specs`):

- one recurrent decoder layer (`transformer._layer_full` with want_cache,
  the prefill's path, then `transformer._layer_decode` from a whole state,
  every row and `rows=` a subset) on 2 and 4 ranks against one device:
  outputs and states within 1e-6 of the one-device value's max (measured
  4.6e-7), for the RG-LRU layer (lru width 256), Mamba2 with one group
  (every rank holds its B/C columns; the state's gather takes them from
  rank 0 only) and with two groups of 8 heads (on 4 ranks two ranks
  share each group), and the variants the axis does not divide (an
  RG-LRU width of 255, 15 SSM heads: the part runs whole, its state
  ungathered); the all-reduces of each call exactly (4 an RG-LRU layer:
  the conv gather, its output, the MLP's, the state's; 3 a Mamba2 layer:
  the norm, its output, the state; a whole part only its MLP's);
- reduced recurrentgemma-9b (r, r, a; a 16-slot decode ring, its window:
  8 slots a rank, so the ring wraps and both ranks hold live slots) and
  reduced mamba2-130m (2 layers) on (1, 1, 2) and (2, 2, 2): prefill,
  `prefill_into_cache_split` and 8 greedy decode steps, the checks of
  tests/test_torch_tensor_parallel_serving.py (tokens the reference's own
  one-device steps'; logits 1e-5 and caches 1e-5 of the one-device max,
  positions exact; the all-reduces exactly, tests/_torch_tp_serving.py;
  no full-length attention cache or (B, V) logits on a rank; each
  recurrent state whole for the rank's rows).
"""
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import _torch_tp as H  # noqa: E402
import _torch_tp_serving as SV  # noqa: E402
from _torch_dist import spawn  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

OP_TOL = 1e-6            # of the one-device value's max |value|
close = SV.close
ARCHS = ("recurrentgemma-9b", "mamba2-130m")
CACHE_LENS = {"recurrentgemma-9b": 16}     # its reduced window
MESHES = {"1x1x2": (1, 1, 2), "2x2x2": (2, 2, 2)}


# ------------------------------------------------------------ one layer

@pytest.fixture(scope="module")
def layer_one_device():
    return {c: H.run_layer(c, H.layer_inputs(c)) for c in H.LAYER_CASES}


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def layer_runs(request, tmp_path_factory):
    world = request.param
    return world, spawn(H.layer_ranks, world,
                        tmp_path_factory.mktemp(f"layer{world}"),
                        H.LAYER_CASES)


@pytest.mark.parametrize("case", H.LAYER_CASES)
def test_layer_matches_one_device(layer_runs, layer_one_device, case):
    """The prefill's output and its gathered state, and both decode
    steps' outputs and new states (rows 1 and 3 untouched by the `rows=`
    step) on every rank against one device's."""
    world, ranks = layer_runs
    want = layer_one_device[case]
    for r, res in enumerate(ranks):
        got = res[case]
        for name in ("prefill_out", "decode_all", "decode_rows"):
            close(got[name], want[name], OP_TOL,
                  f"{case} {name} rank {r} of {world}")
        for name in ("prefill_state", "state_all", "state_rows"):
            assert set(got[name]) == set(want[name])
            for k in want[name]:
                close(got[name][k], want[name][k], OP_TOL,
                      f"{case} {name}/{k} rank {r} of {world}")
    inp = H.layer_inputs(case)["state"]
    for k, v in layer_one_device[case]["state_rows"].items():
        kept = [b for b in range(H.LAYER_ROWS) if b not in H.DECODE_ROWS]
        assert torch.equal(v[kept], torch.from_numpy(inp[k])[kept]), k


def test_layer_all_reduces(layer_runs):
    world, ranks = layer_runs
    want = {"rglru": 4, "rglru_255": 1, "mamba2": 3, "mamba2_g2": 3,
            "mamba2_15": 0}
    for res in ranks:
        for case in H.LAYER_CASES:
            split = case in ("rglru", "mamba2", "mamba2_g2")
            assert res[case]["split"] == split, (case, world)
            assert res[case]["all_reduces"] == dict.fromkeys(
                ("prefill", "all", "rows"), want[case]), (case, world)


# ------------------------------------------------------------ the archs

@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    return SV.bridged_params(ARCHS, tmp_path_factory)


@pytest.fixture(scope="module")
def one_device(bridged):
    return SV.one_device_runs(bridged[0], CACHE_LENS)


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_runs(request, bridged, tmp_path_factory):
    return SV.mesh_run(MESHES[request.param], ARCHS, bridged[1],
                       tmp_path_factory.mktemp(request.param), CACHE_LENS)


@pytest.mark.parametrize("arch", ARCHS)
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


def test_both_ranks_hold_live_ring_slots(mesh_runs):
    """recurrentgemma's 16-slot ring after 12 prompt positions and 8 steps
    (positions 0-19): every slot live, rank 1's slots 8-15 too."""
    shape, _, ranks = mesh_runs
    pos = ranks[0]["recurrentgemma-9b"]["caches"][2]["pos"]
    assert pos.shape == (H.SERVE_ROWS, CACHE_LENS["recurrentgemma-9b"])
    assert bool((pos[:, 8:] >= 0).all()) and int(pos.max()) == 19, shape
