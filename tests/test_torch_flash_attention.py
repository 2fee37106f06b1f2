"""The port's flash-attention plain version (repro_torch/kernels/
flash_attention/ref.py, what `ops.flash_attention` runs for CPU tensors)
against the reference's Pallas kernel in interpret mode and its oracle,
on the reference's five kernel cases (tests/test_kernels.py FA_CASES) in
f32 and bf16.

Tolerances are the reference kernel test's own: 2e-5 in f32, 2e-2 in
bf16. Inputs are numpy draws from a seed; bf16 inputs are rounded from the
same f32 values on both sides. The kernel itself is tested on the card
(test_torch_flash_attention_cuda.py).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash_attention)
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

FA_CASES = [
    # B, Sq, Sk, nh, nkv, hd, causal, window, bq, bk
    (2, 64, 64, 4, 2, 32, True, None, 16, 16),
    (1, 128, 128, 8, 1, 64, True, 32, 32, 32),      # MQA + sliding window
    (2, 32, 32, 4, 4, 64, True, None, 32, 32),      # MHA, single block
    (1, 40, 40, 2, 2, 16, True, None, 16, 16),      # ragged -> padded
    (1, 64, 64, 6, 2, 32, True, 16, 16, 16),        # window < block
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(B, Sq, Sk, nh, nkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, nh, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, nkv, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, nkv, hd)).astype(np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_matches_reference(case, dtype):
    B, Sq, Sk, nh, nkv, hd, causal, window, bq, bk = case
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _qkv(B, Sq, Sk, nh, nkv, hd)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in arrays)
    pallas = jax_flash_attention(jq, jk, jv, causal=causal, window=window,
                                 block_q=bq, block_k=bk, interpret=True)
    oracle = jax_ref(jq, jk, jv, causal=causal, window=window)
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tdt and tuple(out.shape) == (B, Sq, nh, hd)
    np.testing.assert_array_equal(
        _np(out), _np(attention_ref(tq, tk, tv, window=window)))
    np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=tol)


def test_refuses_non_causal_and_counts_no_cpu_launch():
    q, k, v = (torch.as_tensor(a) for a in _qkv(1, 16, 16, 2, 1, 16))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=False)
    flash_attention(q, k, v, window=4)
    assert flash_attention.launches == before
