"""The hand-written flash-attention CUDA kernel (repro_torch/csrc/
flash_attention.cu) against its plain PyTorch version, on the card.

Skips cleanly where torch sees no CUDA device; the CPU suite holds the
plain version against the JAX reference (test_torch_flash_attention.py).
Imports no JAX: the machine with the card has none. Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_flash_attention_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

pytestmark = pytest.mark.gpu

# the reference's five kernel cases (tests/test_kernels.py FA_CASES, block
# sizes dropped: the kernel tiles on its own) plus the main path's shapes:
# B, S, nh, nkv, hd, window
CASES = [
    (2, 64, 4, 2, 32, None),
    (1, 128, 8, 1, 64, 32),         # MQA + sliding window
    (2, 32, 4, 4, 64, None),        # MHA
    (1, 40, 2, 2, 16, None),        # ragged
    (1, 64, 6, 2, 32, 16),          # window < tile
    (1, 256, 16, 8, 128, None),     # qwen3-1.7b prefill
    (1, 2560, 16, 1, 256, 2048),    # recurrentgemma-9b prefill, ring wraps
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, B, S, nh, nkv, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        a = rng.standard_normal(shape, np.float32)
        return torch.as_tensor(a, device=device).to(dtype)
    return t(B, S, nh, hd), t(B, S, nkv, hd), t(B, S, nkv, hd)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(device, case, dtype):
    B, S, nh, nkv, hd, window = case
    q, k, v = _qkv(device, B, S, nh, nkv, hd, dtype)
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_inputs_need_no_copy(device, dtype):
    """q, k and v sliced out of one fused (B, S, heads, hd) projection, as
    a model could hand them over: the kernel reads them through their
    strides (in bf16 by 16-byte copies: the slices' rows stay aligned)."""
    q, k, v = _qkv(device, 2, 96, 12, 4, 64, dtype)
    qkv = torch.cat([q, k, v], dim=2)             # (B, S, 12+4+4, hd)
    qs, ks, vs = qkv[:, :, :12], qkv[:, :, 12:16], qkv[:, :, 16:]
    assert not qs.is_contiguous()
    out = flash_attention(qs, ks, vs, window=40)
    torch.testing.assert_close(out.float(),
                               attention_ref(q, k, v, window=40).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ragged bf16 shapes on the tensor-core template: a sequence that is no
# multiple of any tile at hd 256 with a window, a single token, and fewer
# query rows than one warp's 16 at the smallest head dims: B, S, nh, nkv,
# hd, window
RAGGED_BF16 = [
    (1, 300, 4, 2, 256, 128),
    (2, 1, 4, 2, 128, None),
    (1, 7, 4, 2, 16, None),
    (2, 13, 4, 1, 32, 5),
]


@pytest.mark.parametrize("case", RAGGED_BF16)
def test_bf16_ragged_shapes_on_the_tensor_cores(device, case):
    B, S, nh, nkv, hd, window = case
    q, k, v = _qkv(device, B, S, nh, nkv, hd, torch.bfloat16, seed=1)
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_repeat_calls_return_equal_bits(device, dtype):
    q, k, v = _qkv(device, 1, 300, 8, 2, 128, dtype)
    a = flash_attention(q, k, v, window=100)
    b = flash_attention(q, k, v, window=100)
    assert torch.equal(a, b)


def test_misaligned_bf16_rows_are_refused(device):
    """The bf16 kernel copies rows 16 bytes at a time: a stride that is no
    multiple of 8 elements, or a base pointer off a 16-byte boundary, is
    refused with ValueError, never read some other way."""
    q, k, v = _qkv(device, 1, 32, 4, 2, 32, torch.bfloat16)
    before = flash_attention.launches
    # rows 4 elements (8 bytes) apart past a multiple of 16 bytes
    wide = torch.zeros((1, 32, 4 * 32 + 4), dtype=torch.bfloat16,
                       device=device)
    qs = wide[:, :, :4 * 32].unflatten(2, (4, 32))
    qs.copy_(q)
    assert qs.stride(1) % 8
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(qs, k, v)
    # a base pointer 2 bytes past an aligned one
    flat = torch.zeros(k.numel() + 1, dtype=torch.bfloat16, device=device)
    ks = flat[1:].view(k.shape)
    ks.copy_(k)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, ks, v)
    assert flash_attention.launches == before
    # the f32 kernel reads element by element: such views are fine there
    q32, k32, v32 = q.float(), k.float(), v.float()
    wide32 = torch.zeros((1, 32, 4 * 32 + 1), device=device)
    qs32 = wide32[:, :, :4 * 32].unflatten(2, (4, 32))
    qs32.copy_(q32)
    flat32 = torch.zeros(k32.numel() + 1, device=device)
    ks32 = flat32[1:].view(k32.shape)
    ks32.copy_(k32)
    out = flash_attention(qs32, ks32, v32)
    torch.testing.assert_close(out, attention_ref(q32, k32, v32),
                               atol=2e-5, rtol=2e-5)


def test_keys_outside_the_window_do_not_leak(device):
    q, k, v = _qkv(device, 1, 200, 4, 2, 64, torch.float32)
    out = flash_attention(q, k, v, window=50)
    # poison the keys query 199 cannot see (j <= 149); rows >= 150 keep
    # their exact output
    k2, v2 = k.clone(), v.clone()
    k2[:, :150] = 1e4
    v2[:, :150] = -1e4
    out2 = flash_attention(q, k2, v2, window=50)
    assert torch.equal(out[:, 199], out2[:, 199])


def test_launch_counter_and_guards(device):
    q, k, v = _qkv(device, 1, 32, 4, 2, 32, torch.float32)
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=False)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :24], k[..., :24], v[..., :24])
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3),
                        k, v)
    assert flash_attention.launches == before + 1
