"""The paged layout's decode variants in the port against the reference:
the speculative verify, one prefill chunk and the chunked scheduler's
mixed decode + chunk, each at three levels — the attention layer
(`layers.attention_*_paged`), the stack (`transformer.*_paged`) and the
step builders (`serve.step.build_decode_fused / build_decode_spec /
build_mixed_step`). Float32 on the CPU, reduced qwen3-1.7b (2 layers, d
256, 4/2 heads, hd 64) with the reference's own weights bridged over;
inputs and pool contents are numpy draws from a seed handed to both.

Tolerance: LOGIT_TOL = 1e-4, the paged engine tests' own (sums taken in
another order). Only the rows a caller reads are compared: a dead slot's
all-zero table row attends nothing (the dense gather gives a mean of V,
the kernel's plain version zeros), and pool row 0, the null block, is
excluded (repeated writes, undefined winner in torch). The builders'
integer outputs (tokens, live flags, budgets, the packed spec output) must
be equal.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import step as JS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import step as TS  # noqa: E402
from _torch_parity import bridged_model, jax_pools, to_np  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

TOL = 1e-4
BS = 4


@pytest.fixture(scope="module")
def model():
    return bridged_model("qwen3-1.7b")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.as_tensor(a)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(to_np(t), to_np(j), atol=tol, rtol=tol)


def _jit(fn, *static_names):
    return jax.jit(fn, static_argnums=1, static_argnames=static_names)


def _layer0(model):
    jcfg, tcfg, jp, tp = model
    ja = jax.tree.map(lambda a: a[0], jp["blocks"][0])["attn"]
    return jcfg, tcfg, ja, tp["layers"][0]["attn"]


def _layer_pools(rng, cfg, P):
    shape = (P, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    return _both(_rand(rng, *shape)), _both(_rand(rng, *shape))


def _caches(rng, cfg, P):
    """A random paged cache for the whole stack: (reference layout,
    port layout)."""
    shape = (cfg.n_layers, P, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    k, v = _rand(rng, *shape), _rand(rng, *shape)
    jc = {"blocks": ({"k": jnp.asarray(k), "v": jnp.asarray(v)},),
          "tail": ()}
    tc = [{"k": torch.as_tensor(k[i]).clone(),
           "v": torch.as_tensor(v[i]).clone()} for i in range(cfg.n_layers)]
    return jc, tc


def _close_caches(tc, jc, n_layers):
    for (tk, tv), (jk, jv) in zip(([p["k"], p["v"]] for p in tc),
                                  jax_pools(jc, n_layers)):
        _close(tk[1:], jk[1:])
        _close(tv[1:], jv[1:])


# a table of three slots over 6 pages of 4: slot 1 is dead (all-null row),
# slot 2's chain is short, so a burst past its pages lands in block 0
TABLE = np.array([[7, 2, 11, 5, 0, 0],
                  [0, 0, 0, 0, 0, 0],
                  [1, 3, 0, 0, 0, 0]], np.int32)
LIVE = [0, 2]


# ----------------------------------------------------------------- layers

@pytest.mark.parametrize("pos0", [(9, 0, 5), (13, 0, 22)])
def test_attention_verify_paged(model, pos0):
    """T = 4 tokens per slot; the second case runs slot 2's burst past the
    table's span (positions 22..25 of 24): those scatter into block 0."""
    jcfg, tcfg, ja, ta = _layer0(model)
    rng = np.random.default_rng(10)
    (jk, tk), (jv, tv) = _layer_pools(rng, tcfg, 12)
    jt, tt = _both(TABLE)
    jpos, tpos = _both(np.array(pos0, np.int32))
    jx, tx = _both(_rand(rng, 3, 4, tcfg.d_model))
    jo, jk2, jv2 = _jit(JL.attention_verify_paged)(ja, jcfg, jx, jpos, jk,
                                                   jv, jt)
    to, tk2, tv2 = TL.attention_verify_paged(ta, tcfg, tx, tpos, tk, tv, tt)
    _close(to[LIVE], to_np(jo)[LIVE])
    _close(tk2[1:], jk2[1:])
    _close(tv2[1:], jv2[1:])
    assert tk2 is tk and tv2 is tv          # the port updates in place


@pytest.mark.parametrize("start,n_tok", [(0, 4), (8, 3), (20, 4)])
def test_attention_prefill_chunk_paged(model, start, n_tok):
    """A chunk of budget 4 at the prompt's start, a short final chunk, and
    one reaching the end of the table's span (positions 20..23 of 24)."""
    jcfg, tcfg, ja, ta = _layer0(model)
    rng = np.random.default_rng(11)
    (jk, tk), (jv, tv) = _layer_pools(rng, tcfg, 12)
    jt, tt = _both(TABLE[0])
    jx, tx = _both(_rand(rng, 1, 4, tcfg.d_model))
    jo, jk2, jv2 = _jit(JL.attention_prefill_chunk_paged)(
        ja, jcfg, jx, start, n_tok, jk, jv, jt)
    to, tk2, tv2 = TL.attention_prefill_chunk_paged(ta, tcfg, tx, start,
                                                    n_tok, tk, tv, tt)
    _close(to[:, :n_tok], jo[:, :n_tok])
    _close(tk2[1:], jk2[1:])
    _close(tv2[1:], jv2[1:])


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_attention_mixed_paged(model, kernel):
    """Two decoding slots (slot 1 masked) plus a chunk of 3 real tokens of
    4 at position 4 of the chunk slot, whose truncated chain is 2 pages.
    The reference's dense-gather decode read is the oracle for both port
    reads ("cuda" runs the kernel's plain version here)."""
    jcfg, tcfg, ja, ta = _layer0(model)
    rng = np.random.default_rng(12)
    (jk, tk), (jv, tv) = _layer_pools(rng, tcfg, 12)
    table = TABLE.copy()
    table[2] = 0                              # the chunk slot's own row
    ctable = np.array([6, 9], np.int32)
    pos = np.array([9, 0, 0, 4, 5, 6, 7], np.int32)
    jt, tt = _both(table)
    jc, tc = _both(ctable)
    jpos, tpos = _both(pos)
    jx, tx = _both(_rand(rng, 1, 7, tcfg.d_model))
    jo, jk2, jv2 = _jit(JL.attention_mixed_paged, "kernel")(
        ja, jcfg, jx, jpos, 3, jk, jv, jt, jc, kernel="reference")
    to, tk2, tv2 = TL.attention_mixed_paged(ta, tcfg, tx, tpos, 3, tk, tv,
                                            tt, tc, kernel=kernel)
    rows = [0, 3, 4, 5]                       # live decode row, real chunk
    _close(to[0, rows], to_np(jo)[0, rows])
    _close(tk2[1:], jk2[1:])
    _close(tv2[1:], jv2[1:])


# ------------------------------------------------------------------ stack

def test_verify_step_paged(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(13)
    jcache, tcache = _caches(rng, tcfg, 12)
    toks = rng.integers(0, tcfg.vocab_size, (3, 4)).astype(np.int32)
    pos = np.array([9, 0, 6], np.int32)
    jl, jcache = _jit(JT.verify_step_paged)(jp, jcfg, jnp.asarray(toks),
                                            jnp.asarray(pos), jcache,
                                            jnp.asarray(TABLE))
    tl, tcache = TT.verify_step_paged(tp, tcfg, torch.as_tensor(toks),
                                      torch.as_tensor(pos), tcache,
                                      torch.as_tensor(TABLE))
    _close(to_np(tl)[LIVE], to_np(jl)[LIVE])
    _close_caches(tcache, jcache, tcfg.n_layers)


def test_prefill_chunk_paged(model):
    """A prompt of 10 tokens in chunks of 4 through both stacks, on top
    of a resident random prefix of 4 tokens."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(14)
    jcache, tcache = _caches(rng, tcfg, 12)
    chain = TABLE[0]
    prompt = rng.integers(0, tcfg.vocab_size, 10).tolist()
    jchunk = _jit(JT.prefill_chunk_paged)
    for start in range(4, 14, 4):
        n = min(4, 14 - start)
        toks = np.zeros((1, 4), np.int32)
        toks[0, :n] = prompt[start - 4:start - 4 + n]
        jl, jcache = jchunk(jp, jcfg, jnp.asarray(toks), start, n, jcache,
                            jnp.asarray(chain))
        tl, tcache = TT.prefill_chunk_paged(tp, tcfg, torch.as_tensor(toks),
                                            start, n, tcache,
                                            torch.as_tensor(chain))
        _close(tl[:, :n], jl[:, :n])
    _close_caches(tcache, jcache, tcfg.n_layers)


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_mixed_step_paged(model, kernel):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(15)
    jcache, tcache = _caches(rng, tcfg, 12)
    table = TABLE.copy()
    table[2] = 0
    ctable = np.array([6, 9], np.int32)
    toks = rng.integers(0, tcfg.vocab_size, 7).astype(np.int32)
    pos = np.array([9, 0, 0, 4, 5, 6, 7], np.int32)
    jl, jcache = _jit(JT.mixed_step_paged, "kernel")(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), 3, jcache,
        jnp.asarray(table), jnp.asarray(ctable), kernel="reference")
    tl, tcache = TT.mixed_step_paged(
        tp, tcfg, torch.as_tensor(toks), torch.as_tensor(pos), 3, tcache,
        torch.as_tensor(table), torch.as_tensor(ctable), kernel=kernel)
    rows = [0, 3, 4, 5]
    _close(to_np(tl)[rows], to_np(jl)[rows])
    _close_caches(tcache, jcache, tcfg.n_layers)


# granite-4.0-h-small's multipliers, which the reference lacks: the paged
# forwards must compute one model under the port's settings too
GRANITE = dict(embedding_multiplier=12.0, attention_multiplier=0.0078125,
               residual_multiplier=0.22, logits_scaling=16.0)
SETTINGS = pytest.mark.parametrize("settings", [{}, GRANITE],
                                   ids=["default", "granite-multipliers"])


@SETTINGS
def test_mixed_step_matches_chunk_oracle_and_decode(model, settings):
    """In the port alone: the mixed step's chunk rows and pool equal the
    chunk-only oracle (`prefill_chunk_paged`), and its decode rows equal
    `decode_step_paged` over the same pools (the reference's
    test_scheduler.py pins the same pair), at the default settings and
    at Granite's multipliers."""
    _, tcfg, _, tp = model
    tcfg = dataclasses.replace(tcfg, **settings)
    rng = np.random.default_rng(16)
    _, mixed_cache = _caches(rng, tcfg, 12)
    split_cache = [{k: t.clone() for k, t in p.items()} for p in mixed_cache]
    table = torch.tensor(TABLE)
    table[2] = 0
    ctable = torch.as_tensor(np.array([6, 9], np.int32))
    dtok = torch.as_tensor(rng.integers(0, tcfg.vocab_size, (3, 1))
                           .astype(np.int32))
    ctok = torch.zeros((1, 4), dtype=torch.int32)
    ctok[0, :3] = torch.as_tensor(rng.integers(0, tcfg.vocab_size, 3))
    dpos = torch.tensor([9, 0, 0], dtype=torch.int32)
    cpos = torch.arange(4, 8, dtype=torch.int32)
    ml, _ = TT.mixed_step_paged(tp, tcfg, torch.cat([dtok[:, 0], ctok[0]]),
                                torch.cat([dpos, cpos]), 3, mixed_cache,
                                table, ctable)
    cl, _ = TT.prefill_chunk_paged(tp, tcfg, ctok, 4, 3, split_cache, ctable)
    dl, _ = TT.decode_step_paged(tp, tcfg, dtok, dpos, split_cache, table)
    _close(ml[3:6], cl[0, :3], 1e-5)
    _close(ml[0], dl[0, 0], 1e-5)
    for m, s in zip(mixed_cache, split_cache):
        for key in ("k", "v"):
            _close(m[key][1:], s[key][1:], 1e-5)


@SETTINGS
def test_verify_step_at_one_token_matches_decode(model, settings):
    """In the port alone: the verify forward of one token per slot equals
    `decode_step_paged` on the live slots, logits and pools, at the
    default settings and at Granite's multipliers."""
    _, tcfg, _, tp = model
    tcfg = dataclasses.replace(tcfg, **settings)
    rng = np.random.default_rng(17)
    _, verify_cache = _caches(rng, tcfg, 12)
    decode_cache = [{k: t.clone() for k, t in p.items()}
                    for p in verify_cache]
    table = torch.tensor(TABLE)
    toks = torch.as_tensor(rng.integers(0, tcfg.vocab_size, (3, 1))
                           .astype(np.int32))
    pos = torch.tensor([9, 0, 6], dtype=torch.int32)
    vl, _ = TT.verify_step_paged(tp, tcfg, toks, pos, verify_cache, table)
    dl, _ = TT.decode_step_paged(tp, tcfg, toks, pos, decode_cache, table)
    _close(vl[LIVE], dl[LIVE], 1e-5)
    for a, b in zip(verify_cache, decode_cache):
        for key in ("k", "v"):
            _close(a[key][1:], b[key][1:], 1e-5)


# --------------------------------------------------------------- builders

def _fused_operands(rng, cfg):
    """Three slots: slot 0 with EOS set to what it will emit second (so
    it stops early), slot 1 dead, slot 2 with a budget of 2 of the 4
    steps."""
    toks = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    pos = np.array([9, 0, 5], np.int32)
    live = np.array([True, False, True])
    steps = np.array([10, 0, 2], np.int32)
    return toks, pos, live, steps


def test_build_decode_fused(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(17)
    jcache, tcache = _caches(rng, tcfg, 12)
    toks, pos, live, steps = _fused_operands(rng, tcfg)
    jf = jax.jit(JS.build_decode_fused(jcfg, 4))
    # a first run without EOS finds slot 0's second token; the second run
    # stops slot 0 there
    eos = np.full((3,), -1, np.int32)
    for _ in range(2):
        args = [toks, pos, TABLE, eos, live, steps]
        je, jlive, jsteps, jc2 = jf(jp, jnp.asarray(toks), jnp.asarray(pos),
                                    jcache, *map(jnp.asarray, args[2:]))
        tf = TS.build_decode_fused(tcfg, 4)
        tcache2 = [{k: t.clone() for k, t in p.items()} for p in tcache]
        te, tlive, tsteps, tc2 = tf(tp, *map(torch.as_tensor, args[:2]),
                                    tcache2,
                                    *map(torch.as_tensor, args[2:]))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tlive.numpy(), np.asarray(jlive))
        np.testing.assert_array_equal(tsteps.numpy(), np.asarray(jsteps))
        _close_caches(tc2, jc2, tcfg.n_layers)
        eos = np.array([np.asarray(je)[1, 0], -1, -1], np.int32)
    assert np.asarray(je)[1, 0] == -1 and not np.asarray(jlive)[0]


def test_build_decode_spec(model):
    """K = 3 drafts per slot: slot 0's drafts become the model's own
    greedy continuation (each verify's emitted tokens are the next
    round's drafts), slot 2's stay random; slot 2's budget cuts its
    emission."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(18)
    jcache, tcache = _caches(rng, tcfg, 12)
    toks = rng.integers(0, tcfg.vocab_size, (3, 1)).astype(np.int32)
    pos = np.array([9, 0, 5], np.int32)
    inp = np.zeros((3, 6), np.int32)
    inp[:, :3] = rng.integers(0, tcfg.vocab_size, (3, 3))
    inp[:, 3] = -1
    inp[:, 4] = [10, 0, 2]
    inp[:, 5] = [1, 0, 1]
    jspec = jax.jit(JS.build_decode_spec(jcfg, 3))
    tspec = TS.build_decode_spec(tcfg, 3)
    for _ in range(3):
        jo, jc2 = jspec(jp, jnp.asarray(toks), jnp.asarray(pos), jcache,
                        jnp.asarray(TABLE), jnp.asarray(inp))
        tcache2 = [{k: t.clone() for k, t in p.items()} for p in tcache]
        to, tc2 = tspec(tp, torch.as_tensor(toks), torch.as_tensor(pos),
                        tcache2, torch.as_tensor(TABLE),
                        torch.as_tensor(inp))
        assert to.dtype == torch.int32 and tuple(to.shape) == (8, 3)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        _close_caches(tc2, jc2, tcfg.n_layers)
        inp[0, :3] = np.asarray(jo)[:3, 0]      # the model's own tokens
    assert np.asarray(jo)[5, 0] >= 2            # n_acc: real acceptances


@pytest.mark.parametrize("return_logits", [False, True])
def test_build_mixed_step(model, return_logits):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(19)
    jcache, tcache = _caches(rng, tcfg, 12)
    table = TABLE.copy()
    table[2] = 0
    ctable = np.array([6, 9], np.int32)
    toks = rng.integers(0, tcfg.vocab_size, (3, 1)).astype(np.int32)
    pos = np.array([9, 0, 0], np.int32)
    ctoks = np.zeros((1, 4), np.int32)
    ctoks[0, :3] = rng.integers(0, tcfg.vocab_size, 3)
    jd, jc, jc2 = jax.jit(JS.build_mixed_step(
        jcfg, return_logits=return_logits))(
        jp, jnp.asarray(toks), jnp.asarray(pos), jcache, jnp.asarray(table),
        jnp.asarray(ctoks), jnp.asarray(4, jnp.int32),
        jnp.asarray(3, jnp.int32), jnp.asarray(ctable))
    td, tc, tc2 = TS.build_mixed_step(tcfg, return_logits=return_logits)(
        tp, torch.as_tensor(toks), torch.as_tensor(pos), tcache,
        torch.as_tensor(table), torch.as_tensor(ctoks), 4, 3,
        torch.as_tensor(ctable))
    if return_logits:
        _close(td[0], jd[0])
        _close(tc, jc)
    else:
        assert int(td[0]) == int(jd[0]) and int(tc) == int(jc)
    _close_caches(tc2, jc2, tcfg.n_layers)
