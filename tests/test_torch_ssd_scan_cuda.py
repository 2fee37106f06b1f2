"""The hand-written SSD chunked-scan CUDA kernel (repro_torch/csrc/
ssd_scan.cu) against its plain PyTorch version (the sequential
recurrence), on the card.

Skips cleanly where torch sees no CUDA device; the CPU suite holds the
plain version against the JAX reference (test_torch_ssd_scan.py). Imports
no JAX: the machine with the card has none. Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_ssd_scan_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_ref

pytestmark = pytest.mark.gpu

# the reference's four kernel cases (tests/test_kernels.py SSD_CASES), a
# ragged sequence and mamba2-130m's bulk prefill at 2,048 tokens:
# b, s, h, p, g, n, and the reference's chunk (the kernel runs 64-token
# chunks whatever the model's)
CASES = [
    (2, 32, 4, 16, 1, 8, 8),
    (1, 64, 2, 8, 2, 16, 16),
    (2, 16, 4, 32, 1, 32, 16),
    (1, 128, 3, 16, 1, 8, 32),
    (1, 1000, 24, 64, 1, 128, 256),
    (1, 2048, 24, 64, 1, 128, 256),
]
# the reference kernel test's tolerances
TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's f32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _inputs(device, b, s, h, p, g, n, dtype, seed=1):
    """x, B, C in `dtype`; dt = softplus(N(0,1)) * 0.1 and A = -exp(N(0,1)
    * 0.5) in f32, as the reference's kernel test draws them."""
    rng = np.random.default_rng(seed)

    def t(a, to=dtype):
        return torch.as_tensor(a, dtype=torch.float32, device=device).to(to)
    x = t(rng.standard_normal((b, s, h, p)))
    dt = t(np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1,
           torch.float32)
    A = t(-np.exp(rng.standard_normal((h,)) * 0.5), torch.float32)
    B = t(rng.standard_normal((b, s, g, n)))
    C = t(rng.standard_normal((b, s, g, n)))
    return x, dt, A, B, C


def _check(out, ref, dtype):
    y, st = out
    ry, rst = ref
    assert y.dtype == dtype and st.dtype == torch.float32
    assert y.shape == ry.shape and st.shape == rst.shape
    torch.testing.assert_close(y.float(), ry, atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(st, rst, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(device, case, dtype):
    args = _inputs(device, *case[:6], dtype)
    out = ssd_scan(*args)
    torch.cuda.synchronize()
    _check(out, ssd_ref(*args), dtype)


def test_strided_inputs_need_no_copy(device):
    """x, B and C sliced out of one (b, s, conv_dim) tensor and dt out of
    a wider projection, as `mamba2_forward` hands them over: the kernel
    reads them through their strides."""
    b, s, h, p, g, n = 2, 300, 6, 32, 2, 64
    x, dt, A, B, C = _inputs(device, b, s, h, p, g, n, torch.float32)
    xBC = torch.cat([x.reshape(b, s, h * p), B.reshape(b, s, g * n),
                     C.reshape(b, s, g * n)], dim=-1)
    xs = xBC[..., :h * p].reshape(b, s, h, p)
    Bs = xBC[..., h * p:h * p + g * n].reshape(b, s, g, n)
    Cs = xBC[..., h * p + g * n:].reshape(b, s, g, n)
    dts = torch.cat([dt, dt], dim=-1)[..., :h]
    assert not (xs.is_contiguous() or Bs.is_contiguous()
                or dts.is_contiguous())
    _check(ssd_scan(xs, dts, A, Bs, Cs), ssd_ref(x, dt, A, B, C),
           torch.float32)


def test_launch_counter_guards_and_refused_launch(device):
    x, dt, A, B, C = _inputs(device, 1, 40, 4, 16, 2, 8, torch.float32)
    before = ssd_scan.launches
    ssd_scan(x, dt, A, B, C)
    assert ssd_scan.launches == before + 1
    with pytest.raises(ValueError, match="dtypes"):
        ssd_scan(x, dt, A, B.bfloat16(), C)
    with pytest.raises(ValueError, match="float32"):
        ssd_scan(x, dt.bfloat16(), A, B, C)
    with pytest.raises(ValueError, match="groups"):
        ssd_scan(x[:, :, :3], dt[:, :, :3], A[:3], B, C)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B,
                 C)
    with pytest.raises(ValueError, match="d_state"):
        big = torch.zeros((1, 40, 2, 300), device=device)
        ssd_scan(x, dt, A, big, big)
    assert ssd_scan.launches == before + 1
    # past the wrapper's checks, the kernel's own launcher refuses a
    # d_state beyond its shared memory, and the refusal raises
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    big = torch.zeros((1, 40, 2, 512), device=device)
    with pytest.raises(RuntimeError, match="launch failed"):
        ssd_scan_kernel(x, dt, A, big, big)
