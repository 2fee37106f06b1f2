"""The hand-written RG-LRU scan CUDA kernel (repro_torch/csrc/
rglru_scan.cu) against its plain PyTorch version, on the card.

Skips cleanly where torch sees no CUDA device; the CPU suite holds the
plain version against the JAX reference (test_torch_rglru_scan.py).
Imports no JAX: the machine with the card has none. Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_rglru_scan_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_ref

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
