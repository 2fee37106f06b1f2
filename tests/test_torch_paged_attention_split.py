"""The paged-attention kernel's split plan (`ops.split_plan`) and its
split-and-combine arithmetic in plain torch (`ref.paged_attention_split_ref`),
on the CPU.

The CUDA kernel splits each page chain across blocks and folds the splits in
a second launch; neither runs here. What does: the plan the wrapper hands
the kernel, and the same two passes in plain torch, held against the port's
dense-gather plain version, the reference's dense-gather oracle and the
reference's Pallas kernel in interpret mode. Tolerances are the reference
kernel test's own: 2e-5 in f32, 2e-2 in bf16. The kernel itself is tested on
the card (test_torch_paged_attention_cuda.py).
"""
import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention as jax_paged_attention)
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    MIN_SPLIT_TOKENS, TARGET_BLOCKS, SplitPlan, split_plan)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    NEG_INF, paged_attention_ref, paged_attention_split_ref)
from _torch_parity import one_torch_thread  # noqa: E402,F401

# B, nb, bs, nkv, rep, hd, fills (tokens resident per slot; 0 = empty slot)
CASES = [
    (2, 4, 8, 2, 2, 32, (32, 32)),          # the reference's five
    (2, 4, 8, 4, 1, 32, (32, 19)),
    (3, 4, 8, 1, 4, 64, (9, 1, 27)),
    (4, 3, 16, 2, 2, 32, (17, 0, 48, 0)),
    (1, 6, 8, 2, 3, 16, (41,)),
    (2, 12, 8, 2, 2, 32, (90, 33)),         # block sizes 8, 16, 32
    (2, 6, 16, 2, 2, 32, (90, 33)),
    (2, 3, 32, 2, 2, 32, (90, 33)),
]
# a slot whose chain is all null pages though its position is past 0
NULL_CHAIN = (3, 4, 8, 2, 2, 32, (20, 25, 9))
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# main path: batch 8, 8 KV heads, 32 pages of 16 tokens
MAIN = (8, 8, 32, 16)


def _case(B, nb, bs, nkv, rep, hd, fills, *, null_slots=(), seed=0):
    """numpy inputs: fills[b] tokens resident in slot b, pos[b] = fills[b]
    - 1; pool rows handed out shuffled, table tails zero-filled like the
    engine's. A slot in null_slots keeps its position but maps every page
    to the null block 0."""
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    kpool = rng.standard_normal((P, bs, nkv, hd)).astype(np.float32)
    vpool = rng.standard_normal((P, bs, nkv, hd)).astype(np.float32)
    q = rng.standard_normal((B, nkv * rep, hd)).astype(np.float32)
    rows = list(rng.permutation(np.arange(1, P)))
    table = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    for b in range(B):
        if fills[b] > 0 and b not in null_slots:
            need = -(-fills[b] // bs)
            table[b, :need] = [rows.pop() for _ in range(need)]
        pos[b] = max(fills[b] - 1, 0)
    return q, kpool, vpool, table, pos


def _torch(args, tdt):
    q, kp, vp, table, pos = args
    return (torch.as_tensor(q).to(tdt), torch.as_tensor(kp).to(tdt),
            torch.as_tensor(vp).to(tdt), torch.as_tensor(table),
            torch.as_tensor(pos))


def _jax(args, jdt):
    q, kp, vp, table, pos = args
    return (jnp.asarray(q).astype(jdt), jnp.asarray(kp).astype(jdt),
            jnp.asarray(vp).astype(jdt), jnp.asarray(table), jnp.asarray(pos))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _one_page_splits(nb):
    """The finest plan: every page a split of its own."""
    return SplitPlan(nb, 1, tuple((j, j + 1) for j in range(nb)))


@pytest.mark.parametrize("case", CASES + [NULL_CHAIN])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_ref_matches_plain_version_and_reference(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    null = (1,) if case is NULL_CHAIN else ()
    args = _case(*case, null_slots=null)
    targs, jargs = _torch(args, tdt), _jax(args, jdt)
    plain = paged_attention_ref(*targs)
    pallas = jax_paged_attention(*jargs, kernel="pallas", interpret=True)
    oracle = jax_ref(*jargs)
    nb = case[1]
    for plan in (None, _one_page_splits(nb)):
        out = paged_attention_split_ref(*targs, plan=plan)
        assert out.dtype == tdt and tuple(out.shape) == args[0].shape
        np.testing.assert_allclose(_np(out), _np(plain), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=tol)
        for b, f in enumerate(case[6]):
            if f == 0 or b in null:   # nothing to attend: exact zeros
                assert torch.equal(out[b], torch.zeros_like(out[b]))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_ref_long_chains_many_splits_last_partial(dtype):
    """2,048-token chains (nb 128): the plan gives many splits, the last
    one shorter than the rest; ragged and empty slots ride along."""
    jdt, tdt, tol = DTYPES[dtype]
    case = (5, 128, 16, 8, 2, 16, (2048, 2047, 1, 0, 1500))
    plan = split_plan(5, 8, 128, 16)
    assert plan.n_splits >= 8
    assert plan.ranges[-1][1] - plan.ranges[-1][0] < plan.pages_per_split
    args = _case(*case)
    targs = _torch(args, tdt)
    out, (acc, m, l) = paged_attention_split_ref(*targs,
                                                 return_partials=True)
    assert acc.shape == (5, 16, plan.n_splits, 16)
    np.testing.assert_allclose(_np(out), _np(paged_attention_ref(*targs)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(jax_ref(*_jax(args, jdt))),
                               atol=tol, rtol=tol)
    assert torch.equal(out[3], torch.zeros_like(out[3]))
    # slot 2 holds one token: only split 0 attends anything
    assert (l[2, :, 0] > 0).all()
    assert (m[2, :, 1:] == NEG_INF).all() and (l[2, :, 1:] == 0).all()
    assert (acc[2, :, 1:] == 0).all()


def test_empty_splits_leave_the_start_state():
    """A split with nothing to attend (past pos, or on null pages) leaves
    m = -1e30, l = 0 and acc = 0, which the combine weighs to nothing."""
    args = _torch(_case(*NULL_CHAIN, null_slots=(1,)), torch.float32)
    out, (acc, m, l) = paged_attention_split_ref(
        *args, plan=_one_page_splits(NULL_CHAIN[1]), return_partials=True)
    pos = args[4].tolist()
    bs = NULL_CHAIN[2]
    for b in range(NULL_CHAIN[0]):
        for s in range(NULL_CHAIN[1]):
            empty = b == 1 or s > pos[b] // bs
            assert bool((m[b, :, s] == NEG_INF).all()) == empty
            assert bool((l[b, :, s] == 0).all()) == empty
            if empty:
                assert (acc[b, :, s] == 0).all()
    assert torch.equal(out[1], torch.zeros_like(out[1]))


def test_split_ref_is_bitwise_repeatable():
    args = _torch(_case(*CASES[5]), torch.bfloat16)
    a = paged_attention_split_ref(*args, plan=_one_page_splits(CASES[5][1]))
    b = paged_attention_split_ref(*args, plan=_one_page_splits(CASES[5][1]))
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [
    MAIN, (1, 1, 1, 1), (1, 1, 6, 8), (2, 2, 3, 16), (5, 8, 128, 16),
    (6, 2, 128, 16), (1, 2, 1000, 8), (64, 8, 32, 16), (3, 4, 17, 32),
])
def test_plan_covers_every_page_exactly_once(shape):
    B, nkv, nb, bs = shape
    plan = split_plan(*shape)
    assert plan.n_splits == len(plan.ranges) >= 1
    covered = [j for lo, hi in plan.ranges for j in range(lo, hi)]
    assert covered == list(range(nb))                 # once each, in order
    for s, (lo, hi) in enumerate(plan.ranges):
        assert lo == s * plan.pages_per_split and hi > lo  # none empty
        assert hi - lo <= plan.pages_per_split
    # no split under MIN_SPLIT_TOKENS positions unless the chain is shorter
    assert plan.pages_per_split * bs >= min(MIN_SPLIT_TOKENS, nb * bs)


def test_plan_at_the_main_shape():
    """Batch 8, 8 KV heads, 512-token chains of 16-token pages: 8 splits of
    4 pages, 512 blocks, and with every slot at the end of its chain no
    split is empty."""
    B, nkv, nb, bs = MAIN
    plan = split_plan(*MAIN)
    assert (plan.n_splits, plan.pages_per_split) == (8, 4)
    assert B * nkv * plan.n_splits == TARGET_BLOCKS
    args = _torch(_case(B, nb, bs, nkv, 2, 16, (512,) * B), torch.float32)
    _, (_, m, l) = paged_attention_split_ref(*args, return_partials=True)
    assert (l > 0).all() and (m > NEG_INF).all()


def test_plan_ignores_pool_contents():
    """The plan is a function of (B, nkv, nb, bs) alone: it takes nothing
    else, and poison anywhere a slot may not attend (pages past its
    frontier, the tail of its frontier page, unused rows) moves no bit of
    the split-and-combine output."""
    assert list(inspect.signature(split_plan).parameters) == [
        "B", "nkv", "nb", "bs"]
    q, kp, vp, table, pos = _case(2, 6, 8, 2, 2, 32, (48, 48))
    pos = np.array([11, 30], np.int32)
    out = paged_attention_split_ref(
        *_torch((q, kp, vp, table, pos), torch.float32),
        plan=_one_page_splits(6))
    keep = np.zeros(kp.shape[:2], bool)
    for b in range(2):
        for t in range(pos[b] + 1):
            keep[table[b, t // 8], t % 8] = True
    kp2 = np.where(keep[:, :, None, None], kp, 1e4).astype(np.float32)
    vp2 = np.where(keep[:, :, None, None], vp, -1e4).astype(np.float32)
    out2 = paged_attention_split_ref(
        *_torch((q, kp2, vp2, table, pos), torch.float32),
        plan=_one_page_splits(6))
    assert torch.equal(out, out2)


def test_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="positive"):
        split_plan(0, 8, 32, 16)
