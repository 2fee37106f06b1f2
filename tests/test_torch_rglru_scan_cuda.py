"""The hand-written RG-LRU scan CUDA kernel (repro_torch/csrc/
rglru_scan.cu) against its plain PyTorch version, on the card: every chunk
it is built for, ragged tiles, determinism and CUDA-graph replay.

Skips cleanly where torch sees no CUDA device; the CPU suite holds the
plain version against the JAX reference (test_torch_rglru_scan.py).
Imports no JAX: the machine with the card has none. Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_rglru_scan_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rglru_scan.kernel import rglru_scan_kernel
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_chunked_ref, rglru_ref

pytestmark = pytest.mark.gpu

# the reference's three kernel cases (tests/test_kernels.py RGLRU_CASES,
# block sizes dropped) and recurrentgemma-9b's prefill: B, S, C
CASES = [(2, 32, 64), (1, 100, 130), (2, 16, 16), (1, 2560, 4096)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _ab(device, B, S, C, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, C))))
    b = rng.standard_normal((B, S, C))
    return (torch.as_tensor(a, dtype=torch.float32, device=device).to(dtype),
            torch.as_tensor(b, dtype=torch.float32, device=device).to(dtype))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(device, case, dtype):
    a, b = _ab(device, *case, dtype)
    y, h = rglru_scan(a, b)
    torch.cuda.synchronize()
    ref = rglru_ref(a, b)
    assert y.dtype == torch.float32 and y.shape == a.shape
    torch.testing.assert_close(y, ref, atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(h, ref[:, -1], atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_launch_counter_and_guards(device):
    a, b = _ab(device, 2, 8, 16, torch.float32)
    before = rglru_scan.launches
    rglru_scan(a, b)
    assert rglru_scan.launches == before + 1
    with pytest.raises(ValueError, match="dtypes"):
        rglru_scan(a, b.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), b)
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(a, b[:, :4])
    assert rglru_scan.launches == before + 1


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("case", [(1, 2560, 4096), (2, 1000, 200),
                                  (1, 2557, 4101), (3, 20, 130)])
def test_every_chunk_and_ragged_tiles(device, case, chunk):
    a, b = _ab(device, *case, torch.float32)
    y = rglru_scan_kernel(a, b, chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, rglru_ref(a, b), atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])
    torch.testing.assert_close(y, rglru_chunked_ref(a, b, chunk),
                               atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_calls_are_bitwise_equal(device, dtype):
    a, b = _ab(device, 1, 2560, 4096, dtype)
    y1, h1 = rglru_scan(a, b)
    y2, h2 = rglru_scan(a, b)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_cuda_graph_replay(device):
    """Captured once and replayed on new inputs: the ready flags and the
    ticket are zeroed inside the graph, so every replay is a fresh scan,
    bitwise equal to an eager call on the same inputs."""
    a, b = _ab(device, 1, 2560, 4096, torch.float32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rglru_scan(a, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, h = rglru_scan(a, b)
    for seed in (1, 2, 3):
        a2, b2 = _ab(device, 1, 2560, 4096, torch.float32, seed=seed)
        a.copy_(a2)
        b.copy_(b2)
        graph.replay()
        torch.cuda.synchronize()
        ye, he = rglru_scan(a2, b2)
        assert torch.equal(y, ye) and torch.equal(h, he)
        torch.testing.assert_close(y, rglru_ref(a2, b2),
                                   atol=TOL[torch.float32],
                                   rtol=TOL[torch.float32])


def test_launcher_refuses_a_chunk_it_was_not_built_for(device):
    a, b = _ab(device, 1, 64, 128, torch.float32)
    with pytest.raises(RuntimeError, match="launch failed"):
        rglru_scan_kernel(a, b, 48)
