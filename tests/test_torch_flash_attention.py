"""The port's flash-attention plain version (repro_torch/kernels/
flash_attention/ref.py, what `ops.flash_attention` runs for CPU tensors)
against the reference's Pallas kernel in interpret mode and its oracle,
on the reference's five kernel cases (tests/test_kernels.py FA_CASES) in
f32 and bf16; the paged variant's plain version (`paged_prefill_ref`, what
`ops.flash_attention_paged` runs for CPU tensors) against the oracle over
the pages gathered into one sequence.

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
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_paged)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, paged_prefill_ref)
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


# S (bucket), n_tok, start, nh, nkv, hd, bs, nb, window
PAGED_CASES = [
    (8, 8, 0, 4, 2, 32, 4, 4, None),
    (8, 5, 6, 4, 2, 32, 4, 5, None),        # start off a page, padded rows
    (16, 9, 13, 6, 2, 16, 4, 8, 7),         # a window
    (4, 4, 20, 8, 1, 64, 8, 4, None),       # a short suffix, MQA
]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_plain_version_matches_oracle(case, dtype):
    """Queries at start .. start + S - 1 over a shuffled table's pages:
    the real rows equal the reference oracle's rows start .. start + n_tok
    - 1 run over the pages gathered into one sequence from position 0
    (dummy queries before `start`); the CPU wrapper runs this version."""
    S, n_tok, start, nh, nkv, hd, bs, nb, window = case
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(7)
    P = nb + 3
    table = rng.permutation(np.arange(1, P))[:nb].astype(np.int32)
    q_all = rng.standard_normal((1, start + S, nh, hd)).astype(np.float32)
    kp, vp = (rng.standard_normal((P, bs, nkv, hd)).astype(np.float32)
              for _ in range(2))
    k_seq, v_seq = (a[table].reshape(1, nb * bs, nkv, hd)[:, :start + S]
                    for a in (kp, vp))
    oracle = jax_ref(*(jnp.asarray(a).astype(jdt)
                       for a in (q_all, k_seq, v_seq)),
                     causal=True, window=window)[:, start:start + n_tok]
    tq = torch.as_tensor(q_all[:, start:]).to(tdt)
    tkp, tvp = (torch.as_tensor(a).to(tdt) for a in (kp, vp))
    tt = torch.as_tensor(table)
    out = paged_prefill_ref(tq, tkp, tvp, tt, start, n_tok, window=window)
    assert out.dtype == tdt and tuple(out.shape) == (1, S, nh, hd)
    np.testing.assert_allclose(_np(out[:, :n_tok]), _np(oracle), atol=tol,
                               rtol=tol)
    before = flash_attention_paged.launches
    np.testing.assert_array_equal(
        _np(flash_attention_paged(tq, tkp, tvp, tt, start, n_tok,
                                  window=window)), _np(out))
    assert flash_attention_paged.launches == before


def test_paged_wrapper_refuses_a_gradient():
    q = torch.zeros((1, 4, 2, 16), requires_grad=True)
    pool = torch.zeros((3, 4, 1, 16))
    with pytest.raises(NotImplementedError, match="flash_attention_paged"):
        flash_attention_paged(q, pool, pool, torch.tensor([1, 2],
                                                          dtype=torch.int32),
                              0, 4)
