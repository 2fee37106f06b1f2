"""The hand-written paged-attention CUDA kernel (repro_torch/csrc/
paged_attention.cu) against its plain PyTorch version, on the card.

Skips cleanly where torch sees no CUDA device; the CPU suite holds the
plain version against the JAX reference (test_torch_paged_attention.py).
Imports no JAX: the machine with the card has none. Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_paged_attention_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

pytestmark = pytest.mark.gpu

# the reference's five kernel cases (tests/test_paged_attention_kernel.py)
# plus the full-width qwen3-1.7b decode shape: B, nb, bs, nkv, rep, hd, fills
CASES = [
    (2, 4, 8, 2, 2, 32, (32, 32)),
    (2, 4, 8, 4, 1, 32, (32, 19)),
    (3, 4, 8, 1, 4, 64, (9, 1, 27)),
    (4, 3, 16, 2, 2, 32, (17, 0, 48, 0)),
    (1, 6, 8, 2, 3, 16, (41,)),
    (8, 32, 16, 8, 2, 128, (512, 300, 1, 0, 17, 256, 511, 64)),
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(device, B, nb, bs, nkv, rep, hd, fills, dtype, seed=0):
    """fills[b]: tokens resident in slot b (0 = empty slot, all-null
    table); pos[b] = fills[b] - 1. Pool rows are handed out shuffled."""
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    kpool = rng.standard_normal((P, bs, nkv, hd), np.float32)
    vpool = rng.standard_normal((P, bs, nkv, hd), np.float32)
    q = rng.standard_normal((B, nkv * rep, hd), np.float32)
    rows = list(rng.permutation(np.arange(1, P)))
    table = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    for b in range(B):
        if fills[b] > 0:
            need = -(-fills[b] // bs)
            table[b, :need] = [rows.pop() for _ in range(need)]
        pos[b] = max(fills[b] - 1, 0)

    def t(a, dt):
        return torch.as_tensor(a, device=device).to(dt)
    return (t(q, dtype), t(kpool, dtype), t(vpool, dtype),
            t(table, torch.int32), t(pos, torch.int32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(device, case, dtype):
    args = _case(device, *case, dtype)
    out = paged_attention(*args, kernel="cuda")
    torch.cuda.synchronize()
    ref = paged_attention_ref(*args)
    assert out.dtype == dtype and out.shape == args[0].shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_empty_slot_rows_are_exact_zeros(device):
    args = _case(device, 3, 4, 8, 2, 2, 32, (16, 0, 24), torch.float32)
    out = paged_attention(*args, kernel="cuda")
    assert torch.equal(out[1], torch.zeros_like(out[1]))


def test_beyond_frontier_pages_do_not_leak(device):
    q, kpool, vpool, table, pos = _case(device, 2, 6, 8, 2, 2, 32,
                                        (12, 12), torch.float32)
    # allocate the whole chain so beyond-frontier pages are real rows
    full = _case(device, 2, 6, 8, 2, 2, 32, (48, 48), torch.float32)[3]
    out = paged_attention(q, kpool, vpool, full, pos, kernel="cuda")
    rows = full[:, 2:].flatten()
    kp, vp = kpool.clone(), vpool.clone()
    kp[rows] = 1e4
    vp[rows] = -1e4
    out2 = paged_attention(q, kp, vp, full, pos, kernel="cuda")
    assert torch.equal(out, out2)
    # frontier page 1 is partly filled: its tokens past pos must not leak
    kp2 = kpool.clone()
    kp2[full[:, 1].long(), 4:] = 1e4
    out3 = paged_attention(q, kp2, vpool, full, pos, kernel="cuda")
    assert torch.equal(out, out3)


def test_launch_counter_and_guards(device):
    args = _case(device, 2, 4, 8, 2, 2, 32, (32, 19), torch.float32)
    before = paged_attention.launches
    paged_attention(*args, kernel="cuda")
    paged_attention(*args, kernel="reference")
    assert paged_attention.launches == before + 1
    q, kpool, vpool, table, pos = args
    with pytest.raises(ValueError, match="window"):
        paged_attention(*args, window=8, kernel="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                        kpool, vpool, table, pos, kernel="cuda")
    with pytest.raises(ValueError, match="int32"):
        paged_attention(q, kpool, vpool, table.long(), pos, kernel="cuda")
    with pytest.raises(ValueError, match="dtype"):
        paged_attention(q, kpool.bfloat16(), vpool, table, pos,
                        kernel="cuda")
    assert paged_attention.launches == before + 1
