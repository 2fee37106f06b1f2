"""The hand-written SSD chunked-scan CUDA kernel (repro_torch/csrc/
ssd_scan.cu) against its plain PyTorch version (the sequential
recurrence), on the card: both routes (bf16 on the tensor cores in three
passes, f32 and shapes off the tiles on the CUDA cores), the route rule and
its counters, strided views, determinism and ragged last chunks.

Skips cleanly where torch sees no CUDA device; the CPU suite holds the
plain version against the JAX reference (test_torch_ssd_scan.py). Imports
no JAX: the machine with the card has none. Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_ssd_scan_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ops import MMA_CHUNK, ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_passes_ref, ssd_ref

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


def _routes(fn):
    """fn's result and the routes the wrapper took meanwhile."""
    before = dict(ssd_scan.route_launches)
    out = fn()
    return out, {k: v - before[k] for k, v in ssd_scan.route_launches.items()
                 if v != before[k]}


def test_routes_and_their_counters(device):
    """bf16 at the main shapes runs the tensor-core route; f32 and bf16
    head dims or d_state off the tiles run the CUDA-core route; each call
    counts once in `launches` and once under its route."""
    for shape, dtype, want in (
            ((1, 2048, 24, 64, 1, 128), torch.bfloat16, "mma"),
            ((1, 1000, 24, 64, 1, 128), torch.bfloat16, "mma"),
            ((1, 2048, 24, 64, 1, 128), torch.float32, "simt"),
            ((2, 32, 4, 16, 1, 8), torch.bfloat16, "simt"),      # n 8
            ((1, 64, 2, 8, 2, 16), torch.bfloat16, "simt"),      # p 8
            ((1, 64, 2, 48, 1, 16), torch.bfloat16, "simt")):    # p 48
        args = _inputs(device, *shape, dtype)
        before = ssd_scan.launches
        out, took = _routes(lambda: ssd_scan(*args))
        torch.cuda.synchronize()
        assert took == {want: 1} and ssd_scan.launches == before + 1
        _check(out, ssd_ref(*args), dtype)


def test_strided_xbc_views_take_the_mma_route(device):
    """x, B and C as the model hands them over in bf16: views of one
    (b, s, conv_dim) tensor (row stride 1,792 at mamba2-130m), read in
    place on the tensor-core route."""
    b, s, h, p, g, n = 1, 777, 24, 64, 1, 128
    x, dt, A, B, C = _inputs(device, b, s, h, p, g, n, torch.bfloat16)
    xBC = torch.cat([x.reshape(b, s, h * p), B.reshape(b, s, g * n),
                     C.reshape(b, s, g * n)], dim=-1)
    xs = xBC[..., :h * p].reshape(b, s, h, p)
    Bs = xBC[..., h * p:h * p + g * n].reshape(b, s, g, n)
    Cs = xBC[..., h * p + g * n:].reshape(b, s, g, n)
    assert xs.stride(1) == 1792 and not xs.is_contiguous()
    assert xs.data_ptr() == xBC.data_ptr()
    out, took = _routes(lambda: ssd_scan(xs, dt, A, Bs, Cs))
    torch.cuda.synchronize()
    assert took == {"mma": 1}
    _check(out, ssd_ref(x, dt, A, B, C), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_calls_are_bitwise_equal(device, dtype):
    args = _inputs(device, 1, 2048, 24, 64, 1, 128, dtype)
    y1, s1 = ssd_scan(*args)
    y2, s2 = ssd_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("s", [20, 100, 1000, 2011, 2048])
def test_every_chunk_and_ragged_last_chunks(device, chunk, s):
    """The tensor-core route at each chunk it is built for, on sequences
    whose last chunk is short (or the only one), against the sequential
    plain version and the plain model of its three passes."""
    args = _inputs(device, 1, s, 24, 64, 1, 128, torch.bfloat16)
    out = kernel.ssd_scan_mma_kernel(*args, chunk)
    torch.cuda.synchronize()
    _check(out, ssd_ref(*args), torch.bfloat16)
    y, state = ssd_chunk_passes_ref(*args, chunk)
    _check(out, (y.float(), state), torch.bfloat16)


def test_mma_route_small_tiles(device):
    """Head dims 16, 32 and 128, d_state 16 and 256, two groups."""
    for shape in ((2, 16, 4, 32, 1, 32), (1, 300, 4, 16, 2, 16),
                  (2, 200, 4, 128, 2, 256)):
        args = _inputs(device, *shape, torch.bfloat16)
        out, took = _routes(lambda: ssd_scan(*args))
        torch.cuda.synchronize()
        assert took == {"mma": 1}
        _check(out, ssd_ref(*args), torch.bfloat16)


def test_mma_launcher_refuses_a_chunk_it_was_not_built_for(device):
    args = _inputs(device, 1, 128, 2, 64, 1, 128, torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel.ssd_scan_mma_kernel(*args, 96)
    assert MMA_CHUNK in (64, 128, 256)
