"""The hand-written flash-attention CUDA kernel (repro_torch/csrc/
flash_attention.cu) against its plain PyTorch version, on the card; its
paged variant (`flash_attention_paged`, the paged bulk prefill's read)
against the plain gather it replaces, alone and in a served bf16 model.

Skips cleanly where torch sees no CUDA device; the CPU suite holds the
plain version against the JAX reference (test_torch_flash_attention.py).
Imports no JAX: the machine with the card has none. Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_flash_attention_cuda.py``.
"""
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_paged)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     paged_prefill_ref)
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.step import build_prefill_paged

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


# ------------------------------------------------------------ paged variant

# S (bucket), n_tok, start, nh, nkv, hd, bs, nb (table columns), window
PAGED_CASES = [
    (128, 128, 0, 32, 8, 128, 16, 12, None),    # longdoc's heads, start 0
    (64, 50, 37, 32, 8, 128, 16, 8, None),      # start off a page, n_tok < S
    (128, 100, 0, 24, 8, 64, 16, 10, None),     # granite's heads
    (64, 16, 200, 24, 8, 64, 16, 16, None),     # a short suffix on a prefix
    (128, 70, 30, 8, 2, 64, 16, 8, 48),         # a window
    (64, 64, 4000, 32, 8, 128, 16, 272, None),  # shared-doc's suffix shape
    (16, 5, 3, 4, 2, 16, 4, 3, None),           # one warp's rows, tiny pages
]


def _paged(device, case, dtype, seed=0):
    """q (1, S, nh, hd), pools of twice the table's pages plus the null
    block, and a table of distinct shuffled block ids (out of order, and
    wider than the sequence)."""
    S, n_tok, start, nh, nkv, hd, bs, nb, _ = case
    rng = np.random.default_rng(seed)
    P = 2 * nb + 1

    def t(*shape):
        a = rng.standard_normal(shape, np.float32)
        return torch.as_tensor(a, device=device).to(dtype)
    q = t(1, S, nh, hd)
    kpool, vpool = t(P, bs, nkv, hd), t(P, bs, nkv, hd)
    table = torch.as_tensor(rng.permutation(np.arange(1, P))[:nb]
                            .astype(np.int32), device=device)
    return q, kpool, vpool, table


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain_version(device, case, dtype):
    S, n_tok, start, _, _, _, _, _, window = case
    q, kp, vp, table = _paged(device, case, dtype)
    before = flash_attention_paged.launches
    out = flash_attention_paged(q, kp, vp, table, start, n_tok,
                                window=window)
    torch.cuda.synchronize()
    assert flash_attention_paged.launches == before + 1
    ref = paged_prefill_ref(q, kp, vp, table, start, n_tok, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out[:, :n_tok].float(),
                               ref[:, :n_tok].float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    # padded rows are written, as exact zeros
    assert torch.equal(out[:, n_tok:], torch.zeros_like(out[:, n_tok:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_reads_only_visible_keys(device, dtype):
    """Keys at or past start + n_tok, the pages past them and the null
    block hold NaN; the real rows' outputs keep their bits, and no NaN
    reaches a padded row."""
    case = (64, 40, 21, 8, 2, 64, 16, 8, None)
    S, n_tok, start, _, _, _, bs, nb, _ = case
    q, kp, vp, table = _paged(device, case, dtype, seed=3)
    out = flash_attention_paged(q, kp, vp, table, start, n_tok)
    kp2, vp2 = kp.clone(), vp.clone()
    end = start + n_tok
    for j in range(end, nb * bs):
        kp2[table[j // bs], j % bs] = float("nan")
        vp2[table[j // bs], j % bs] = float("nan")
    kp2[0], vp2[0] = float("nan"), float("nan")
    table2 = table.clone()
    table2[-(-end // bs):] = 0                 # pages past the end: null
    out2 = flash_attention_paged(q, kp2, vp2, table2, start, n_tok)
    assert torch.equal(out, out2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_repeat_calls_return_equal_bits(device, dtype):
    case = PAGED_CASES[1]
    q, kp, vp, table = _paged(device, case, dtype, seed=1)
    a = flash_attention_paged(q, kp, vp, table, case[2], case[1])
    b = flash_attention_paged(q, kp, vp, table, case[2], case[1])
    assert torch.equal(a, b)


def test_paged_guards(device):
    """A misaligned pool, a wrong dtype, an int64 table or positions past
    the table are refused with ValueError before any launch."""
    case = (32, 20, 5, 4, 2, 64, 16, 4, None)
    q, kp, vp, table = _paged(device, case, torch.bfloat16)
    before = flash_attention_paged.launches
    flat = torch.zeros(kp.numel() + 1, dtype=torch.bfloat16, device=device)
    kp_off = flat[1:].view(kp.shape)           # base 2 bytes off 16
    kp_off.copy_(kp)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_paged(q, kp_off, vp, table, 5, 20)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_paged(q, kp.float(), vp, table, 5, 20)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_paged(q.half(), kp.half(), vp.half(), table, 5, 20)
    with pytest.raises(ValueError, match="int32"):
        flash_attention_paged(q, kp, vp, table.long(), 5, 20)
    with pytest.raises(ValueError, match="past the table"):
        flash_attention_paged(q, kp, vp, table, 50, 20)
    with pytest.raises(ValueError, match="n_tok"):
        flash_attention_paged(q, kp, vp, table, 5, 33)
    assert flash_attention_paged.launches == before
    # no real row: zeros, and nothing launched
    out = flash_attention_paged(q, kp, vp, table, 5, 0)
    assert torch.equal(out, torch.zeros_like(q))
    assert flash_attention_paged.launches == before


def _tiny_model(device, dtype, seed=0):
    cfg = registry.get("qwen3-1.7b", reduced=True).replace(
        dtype=dtype, param_dtype=dtype)
    return (T.init_lm(torch.Generator(device=device).manual_seed(seed), cfg),
            cfg)


def _prompts(cfg, seed=0):
    """Four prompts; the second shares the first's first 70 tokens, so its
    admission reuses four 16-token pages and its prefill starts at 64."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, cfg.vocab_size, 90).tolist()
    return [base, base[:70] + rng.integers(0, cfg.vocab_size, 9).tolist(),
            rng.integers(0, cfg.vocab_size, 33).tolist(),
            rng.integers(0, cfg.vocab_size, 5).tolist()]


def _serve(device, params, cfg, prefill_kernel):
    """Serve `_prompts` greedily on a paged engine with bulk prefill; with
    prefill_kernel="reference" its bulk prefills read through the plain
    gather and its decode reads stay the kernel's, so that only the
    prefill's read differs. Returns the tokens, the paged flash launches,
    the bulk prefills and the cache metrics."""
    eng = ServeEngine(params, cfg, kv_layout="paged", prefill_mode="bulk",
                      batch_slots=2, cache_len=128, block_size=16,
                      device=device)
    if prefill_kernel == "reference":
        eng._prefill_tok = build_prefill_paged(cfg, kernel="reference")
        eng._prefill_lg = build_prefill_paged(cfg, return_logits=True,
                                              kernel="reference")
    reqs = [eng.submit(p, max_new_tokens=6) for p in _prompts(cfg)]
    before = flash_attention_paged.launches
    eng.run()
    torch.cuda.synchronize()
    assert all(r.done and r.error is None for r in reqs)
    return ([r.output for r in reqs], flash_attention_paged.launches - before,
            eng.step_times["prefill"].n, eng.cache_metrics)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_bulk_prefill_launches_once_per_layer(device, dtype):
    """A paged engine with bulk prefill on a tiny model: each bulk prefill
    (a radix hit among them, so one starts past position 0) launches the
    paged kernel once per attention layer, the plain-gather engine none.
    In f32 the greedy tokens equal the plain-gather engine's; in bf16 a
    random-weight model's near-ties flip under rounding (on an H100 the
    plain read's best two logits stood 0 and one bf16 step apart where a
    token flipped, under the reads' logit gap of 0.006-0.008 there), so
    the tokens are held to the plain read by the top-2 rule in
    `test_bf16_prefill_logits_follow_the_plain_read`."""
    params, cfg = _tiny_model(device, dtype)
    out, launches, prefills, metrics = _serve(device, params, cfg, "cuda")
    assert prefills == len(_prompts(cfg)) and metrics.hits >= 1
    assert launches == cfg.n_layers * prefills
    want, ref_launches, _, _ = _serve(device, params, cfg, "reference")
    assert ref_launches == 0
    if dtype == "float32":
        assert out == want


# the bf16 prefill logits' limits, from readings on an H100 over 8 model
# seeds (PERF.md section 6): the kernel's widest relative logit
# error against the plain read 0.0090-0.0122, the planted page misread's
# 0.72-0.99; the share of positions whose best two logits stand clear of
# twice the widest gap 0.69-0.88
LOGIT_REL_TOL = 0.03
CLEAR_SHARE = 0.5


def _misread(table, start, n_tok, bs=16):
    """The table with the middle page the rows attend read from the next
    column's block: a planted fault of a paged read."""
    col = (start + n_tok) // bs // 2
    bad = table.clone()
    bad[col] = table[col + 1]
    return bad


def _faulty_plain_read(q, kpool, vpool, table, start, n_tok, **kw):
    return paged_prefill_ref(q, kpool, vpool, _misread(table, start, n_tok),
                             start, n_tok, **kw)


def _prefill_logits(device, seed):
    """A tiny bf16 model's two bulk prefills of `_prompts`' first prompt,
    one from position 0 and one of its last 26 tokens on the first 64
    reused, each on its own pool: through the kernel ("cuda"), the plain
    gather ("reference"), and the plain gather with `_misread` planted in
    every layer's read ("fault"). Returns one dict of the real positions'
    f32 logits per prefill."""
    params, cfg = _tiny_model(device, "bfloat16", seed)
    table = torch.arange(1, 9, dtype=torch.int32, device=device)
    caches = {k: T.init_paged_cache(cfg, 9, 16, device)
              for k in ("cuda", "reference", "fault")}
    tokens = torch.as_tensor(_prompts(cfg, seed)[0], device=device)
    out = []
    for start, n, S in ((0, 90, 128), (64, 26, 32)):
        toks = torch.zeros((1, S), dtype=torch.int32, device=device)
        toks[0, :n] = tokens[start:start + n]
        lg = {}
        for k, c in caches.items():
            with mock.patch.object(fa_ref, "paged_prefill_ref",
                                   _faulty_plain_read if k == "fault"
                                   else paged_prefill_ref):
                lg[k] = T.forward_prefill_paged(
                    params, cfg, toks, start, n, c, table,
                    kernel="cuda" if k == "cuda" else "reference",
                )[0][0, :n].float()
        out.append(lg)
    return out


def _logit_rel_err(got, want):
    """The widest relative error of one position's logits: max over the
    positions of |got - want| / |want|, the norms over the vocabulary."""
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_prefill_logits_follow_the_plain_read(device, seed):
    """A tiny bf16 model's bulk prefills (`_prefill_logits`): the kernel's
    logits stay within LOGIT_REL_TOL of the plain read's at every real
    position, which the planted page misread exceeds; most positions'
    best two logits (by the plain read) stand further apart than twice
    the widest logit gap between the reads, and at each of those the
    greedy tokens are equal."""
    for lg in _prefill_logits(device, seed):
        ref = lg["reference"]
        assert _logit_rel_err(lg["cuda"], ref) <= LOGIT_REL_TOL
        assert _logit_rel_err(lg["fault"], ref) > LOGIT_REL_TOL
        gap = (lg["cuda"] - ref).abs().max()
        best = ref.topk(2, dim=-1).values
        clear = best[:, 0] - best[:, 1] > 2 * gap
        assert clear.float().mean().item() >= CLEAR_SHARE
        assert torch.equal(lg["cuda"].argmax(-1)[clear],
                           ref.argmax(-1)[clear])


def test_prefill_on_cuda_needs_start(device):
    """On CUDA tensors the paged prefill's attention refuses to read its
    start from the positions (a stall on the device)."""
    from repro_torch.models import layers as L
    params, cfg = _tiny_model(device, "bfloat16")
    cache = T.init_paged_cache(cfg, 9, 16, device)
    x = torch.zeros((1, 16, cfg.d_model), dtype=torch.bfloat16,
                    device=device)
    q_pos = torch.arange(16, device=device)
    table = torch.arange(1, 9, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="start="):
        L.attention_prefill_paged(params["layers"][0]["attn"], cfg, x, q_pos,
                                  16, cache[0]["k"], cache[0]["v"], table)
