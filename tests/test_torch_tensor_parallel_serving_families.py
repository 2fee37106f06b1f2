"""The serving steps tensor parallel over "model" for the MoE decoders and
the encoder-decoder, and on a (2, 2, 2) mesh (rows split over "pod" x
"data" too), on gloo ranks on the CPU, f32 with TF32 off, reduced configs:
tests/test_torch_tensor_parallel_serving.py's arch checks for reduced
granite-moe-1b-a400m and granite-moe-3b-a800m (4 experts top-2: expert
parallel on 2 ranks; the routing whole on every rank) and
seamless-m4t-large-v2 (16 encoder frames a row: cross caches of 8 slots a
rank) on (1, 1, 2), and for reduced qwen3-1.7b, granite-moe-1b-a400m and
seamless on (2, 2, 2), one row a rank: prefill, `prefill_into_cache_split`
and 8 greedy decode steps, the tokens the reference's own one-device
steps', the logits within 1e-5 of the port's one-device steps', the
gathered caches the one-device caches', the all-reduces exactly
(tests/_torch_tp_serving.py), no full-length cache and no (B, V) logits
on a rank.
"""
import pytest

jax = pytest.importorskip("jax")

import _torch_tp_serving as SV  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

FAMILIES = ("granite-moe-1b-a400m", "granite-moe-3b-a800m",
            "seamless-m4t-large-v2")
MESHES = {"1x1x2": ((1, 1, 2), FAMILIES),
          "2x2x2": ((2, 2, 2), ("qwen3-1.7b", "granite-moe-1b-a400m",
                                "seamless-m4t-large-v2"))}


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    return SV.bridged_params(("qwen3-1.7b",) + FAMILIES, tmp_path_factory)


@pytest.fixture(scope="module")
def one_device(bridged):
    return SV.one_device_runs(bridged[0])


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_runs(request, bridged, tmp_path_factory):
    shape, archs = MESHES[request.param]
    return SV.mesh_run(shape, archs, bridged[1],
                       tmp_path_factory.mktemp(request.param))


@pytest.mark.parametrize("arch", FAMILIES)
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
