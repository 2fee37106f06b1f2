"""The port's paged-attention plain version (repro_torch/kernels/
paged_attention/ref.py, what `ops.paged_attention` runs for CPU tensors)
against the reference's Pallas kernel in interpret mode and its dense-
gather oracle, on the reference's five kernel cases in f32 and bf16.

Tolerances are the reference kernel test's own: 2e-5 in f32, 2e-2 in
bf16. Inputs are numpy draws from a seed; bf16 inputs are rounded from the
same f32 values on both sides. The kernel itself is tested on the card
(test_torch_paged_attention_cuda.py).
"""
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention as jax_paged_attention)
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

CASES = [
    # B, nb, bs, nkv, rep, hd, fills (tokens resident per slot)
    (2, 4, 8, 2, 2, 32, (32, 32)),          # GQA grouped, full chains
    (2, 4, 8, 4, 1, 32, (32, 19)),          # n_kv_heads == n_heads (MHA)
    (3, 4, 8, 1, 4, 64, (9, 1, 27)),        # MQA, frontier pages mid-fill
    (4, 3, 16, 2, 2, 32, (17, 0, 48, 0)),   # null-page (empty) slots mixed in
    (1, 6, 8, 2, 3, 16, (41,)),             # long chain, ragged tail page
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _case(B, nb, bs, nkv, rep, hd, fills, seed=0):
    """numpy inputs: fills[b] tokens resident in slot b (0 = empty slot,
    all-null table), pos[b] = fills[b] - 1; pool rows handed out shuffled,
    table tails zero-filled like the engine's."""
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    kpool = rng.standard_normal((P, bs, nkv, hd)).astype(np.float32)
    vpool = rng.standard_normal((P, bs, nkv, hd)).astype(np.float32)
    q = rng.standard_normal((B, nkv * rep, hd)).astype(np.float32)
    rows = list(rng.permutation(np.arange(1, P)))
    table = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    for b in range(B):
        if fills[b] > 0:
            need = -(-fills[b] // bs)
            table[b, :need] = [rows.pop() for _ in range(need)]
        pos[b] = max(fills[b] - 1, 0)
    return q, kpool, vpool, table, pos


def _jax(args, jdt):
    q, kp, vp, table, pos = args
    return (jnp.asarray(q).astype(jdt), jnp.asarray(kp).astype(jdt),
            jnp.asarray(vp).astype(jdt), jnp.asarray(table), jnp.asarray(pos))


def _torch(args, tdt):
    q, kp, vp, table, pos = args
    return (torch.as_tensor(q).to(tdt), torch.as_tensor(kp).to(tdt),
            torch.as_tensor(vp).to(tdt), torch.as_tensor(table),
            torch.as_tensor(pos))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_matches_reference(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    args = _case(*case)
    jargs, targs = _jax(args, jdt), _torch(args, tdt)
    pallas = jax_paged_attention(*jargs, kernel="pallas", interpret=True)
    oracle = jax_ref(*jargs)
    out = paged_attention(*targs, kernel="cuda")     # CPU tensors: plain
    ref = paged_attention_ref(*targs)
    assert out.dtype == tdt and tuple(out.shape) == args[0].shape
    np.testing.assert_array_equal(_np(out), _np(ref))
    np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=tol)


def test_empty_slot_rows_are_zero():
    args = _torch(_case(3, 4, 8, 2, 2, 32, (16, 0, 24)), torch.float32)
    out = paged_attention(*args)
    assert torch.equal(out[1], torch.zeros_like(out[1]))


def test_beyond_frontier_pages_do_not_leak():
    """Allocated-but-unwritten pages past the frontier, and the tail of a
    partly filled frontier page, hold poison: the output must not move."""
    q, kp, vp, table, pos = _case(2, 6, 8, 2, 2, 32, (48, 48))
    pos = np.array([11, 11], np.int32)           # frontier: page 1, offset 3
    args = _torch((q, kp, vp, table, pos), torch.float32)
    out = paged_attention(*args)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[table[:, 2:].ravel()] = 1e4
    vp2[table[:, 2:].ravel()] = -1e4
    kp2[table[:, 1], 4:] = 1e4
    poisoned = _torch((q, kp2, vp2, table, pos), torch.float32)
    assert torch.equal(out, paged_attention(*poisoned))


def test_window_and_kernel_guards():
    args = _torch(_case(1, 2, 8, 2, 2, 16, (10,)), torch.float32)
    with pytest.raises(ValueError, match="window"):
        paged_attention(*args, window=8, kernel="cuda")
    with pytest.raises(ValueError, match="kernel"):
        paged_attention(*args, kernel="pallas")
    # the reference path does accept a window (dense-gather semantics)
    out = paged_attention(*args, window=8, kernel="reference")
    jargs = _jax(_case(1, 2, 8, 2, 2, 16, (10,)), jnp.float32)
    np.testing.assert_allclose(_np(out), _np(jax_ref(*jargs, window=8)),
                               atol=2e-5, rtol=2e-5)


def test_cpu_tensors_never_count_as_launches():
    before = paged_attention.launches
    paged_attention(*_torch(_case(*CASES[0]), torch.float32), kernel="cuda")
    assert paged_attention.launches == before


def test_launch_count_is_exact_under_threads():
    """The gateway's replica workers count launches from threads of their
    own: `add_launches` from 16 threads at a 1 us switch interval loses
    no update, and no thread sees captured calls it did not make."""
    from repro_torch.kernels.paged_attention import ops
    threads, per_thread = 16, 2000
    interval = sys.getswitchinterval()
    seen = []

    def work():
        for _ in range(per_thread):
            ops.add_launches(1)
        seen.append(ops.captured_here())

    before = paged_attention.launches
    pool = [threading.Thread(target=work) for _ in range(threads)]
    sys.setswitchinterval(1e-6)
    try:
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
        total = paged_attention.launches - before
    finally:
        sys.setswitchinterval(interval)
        paged_attention.launches = before
    assert not any(t.is_alive() for t in pool)
    assert total == threads * per_thread
    assert seen == [0] * threads
