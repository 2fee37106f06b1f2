"""repro_torch.models.layers against repro.models.layers, float32 on the
CPU, on reduced qwen3-1.7b (2 layers, d 256, 4/2 heads, hd 64) with the
reference's own weights bridged over. Inputs are numpy draws from a seed
handed to both.

Tolerances: 1e-5 for norms, rope and mlp (a few f32 roundings apart);
2e-5 for attention outputs and updated pools (sums taken in another
order). Pool rows of the null block 0 are not compared: inactive slots and
pad positions all scatter there, and torch leaves the winner of repeated
writes undefined (every read skips or masks block 0).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from _torch_parity import bridged_model, to_np  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

NORM_TOL = 1e-5
ATTN_TOL = 2e-5


@pytest.fixture(scope="module")
def model():
    return bridged_model("qwen3-1.7b")


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jit(fn, *static_names):
    """The reference function jitted with its config static: one compile
    instead of one per eager op."""
    return jax.jit(fn, static_argnums=1, static_argnames=static_names)


def _both(a):
    return jnp.asarray(a), torch.as_tensor(a)


def _close(t, j, tol):
    np.testing.assert_allclose(to_np(t), to_np(j), atol=tol, rtol=tol)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 256), _rand(rng, 256, scale=0.1)
    (jx, tx), (jw, tw) = _both(x), _both(w)
    _close(TL.rms_norm(tx, tw, 1e-6), jax.jit(JL.rms_norm)(jx, jw, 1e-6),
           NORM_TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("start", [0, 37])
def test_apply_rope(theta, start):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 9, 4, 64)
    pos = (start + np.arange(9, dtype=np.int32))[None, :].repeat(2, 0)
    (jx, tx), (jp, tp) = _both(x), _both(pos)
    jrope = jax.jit(JL.apply_rope, static_argnums=2)
    _close(TL.apply_rope(tx, tp, theta), jrope(jx, jp, theta), NORM_TOL)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "starcoder2-7b"])
def test_mlp(arch):
    """SwiGLU (qwen3) and the ungated tanh-GELU MLP (starcoder2)."""
    _, tcfg, jp, tp = bridged_model(arch)
    rng = np.random.default_rng(2)
    jx, tx = _both(_rand(rng, 2, 3, tcfg.d_model))
    jl = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    _close(TL.mlp(tp["layers"][0]["ffn"], tx, tcfg.act),
           jax.jit(JL.mlp, static_argnums=2)(jl["ffn"], jx, tcfg.act), NORM_TOL)


def test_embed_unembed(model):
    _, _, jp, tp = model
    tok = np.array([[0, 5, 511], [3, 3, 7]], np.int32)
    jt, tt = _both(tok)
    je = JL.embed(jp["embed"], jt)
    te = TL.embed(tp["embed"], tt)
    np.testing.assert_array_equal(to_np(te), to_np(je))
    _close(TL.unembed(tp["embed"], te), JL.unembed(jp["embed"], je),
           NORM_TOL)


def _layer0(model):
    jcfg, tcfg, jp, tp = model
    ja = jax.tree.map(lambda a: a[0], jp["blocks"][0])["attn"]
    return jcfg, tcfg, ja, tp["layers"][0]["attn"]


@pytest.mark.parametrize("causal", [True, False])
def test_attention(model, causal):
    jcfg, tcfg, ja, ta = _layer0(model)
    rng = np.random.default_rng(3)
    jx, tx = _both(_rand(rng, 2, 6, tcfg.d_model))
    jpos, tpos = _both(np.arange(6, dtype=np.int32)[None, :])
    jo, (jk, jv) = _jit(JL.attention, "causal")(ja, jcfg, jx, jpos,
                                               causal=causal)
    to, (tk, tv) = TL.attention(ta, tcfg, tx, tpos, causal=causal)
    _close(to, jo, ATTN_TOL)
    _close(tk, jk, ATTN_TOL)
    _close(tv, jv, ATTN_TOL)


def _pools(rng, P, bs, nkv, hd):
    return _both(_rand(rng, P, bs, nkv, hd)), _both(_rand(rng, P, bs, nkv, hd))


def _close_pools(tpool, jpool):
    # row 0 is the null block: repeated scatters, undefined winner in torch
    _close(tpool[1:], jpool[1:], ATTN_TOL)


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_attention_decode_paged(model, kernel):
    """One decode token per slot: slot 1 is empty (all-null table), slot 2
    sits at a page boundary. The reference's dense-gather read is the
    oracle for both port reads ("cuda" runs its plain version here)."""
    jcfg, tcfg, ja, ta = _layer0(model)
    rng = np.random.default_rng(4)
    bs, nb, B = 4, 5, 3
    P = B * nb + 1
    (jk, tk), (jv, tv) = _pools(rng, P, bs, tcfg.n_kv_heads,
                                tcfg.resolved_head_dim)
    table = np.zeros((B, nb), np.int32)
    table[0, :3] = [7, 2, 11]
    table[2, :5] = [1, 3, 5, 9, 4]
    pos = np.array([9, 0, 12], np.int32)
    jt, tt = _both(table)
    jpos, tpos = _both(pos)
    jx, tx = _both(_rand(rng, B, 1, tcfg.d_model))
    jo, jk2, jv2 = _jit(JL.attention_decode_paged, "kernel")(
        ja, jcfg, jx, jpos, jk, jv, jt, kernel="reference")
    to, tk2, tv2 = TL.attention_decode_paged(ta, tcfg, tx, tpos, tk, tv, tt,
                                             kernel=kernel)
    _close(to, jo, ATTN_TOL)
    _close_pools(tk2, jk2)
    _close_pools(tv2, jv2)
    assert tk2 is tk and tv2 is tv          # the port updates in place


@pytest.mark.parametrize("start,n_tok", [(0, 5), (6, 3)])
def test_attention_prefill_paged(model, start, n_tok):
    """Suffix prefill: `start` tokens already resident (radix prefix), the
    suffix right-padded to 8. Only the real rows are compared: pad rows
    may attend null-block garbage."""
    jcfg, tcfg, ja, ta = _layer0(model)
    rng = np.random.default_rng(5)
    bs, nb, S = 4, 5, 8
    (jk, tk), (jv, tv) = _pools(rng, 12, bs, tcfg.n_kv_heads,
                                tcfg.resolved_head_dim)
    table = np.array([3, 8, 1, 0, 0], np.int32)
    q_pos = (start + np.arange(S)).astype(np.int32)
    jt, tt = _both(table)
    jq, tq = _both(q_pos)
    jx, tx = _both(_rand(rng, 1, S, tcfg.d_model))
    jo, jk2, jv2 = _jit(JL.attention_prefill_paged)(ja, jcfg, jx, jq, n_tok,
                                                    jk, jv, jt)
    to, tk2, tv2 = TL.attention_prefill_paged(ta, tcfg, tx, tq, n_tok,
                                              tk, tv, tt)
    _close(to[:, :n_tok], jo[:, :n_tok], ATTN_TOL)
    _close_pools(tk2, jk2)
    _close_pools(tv2, jv2)


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
@pytest.mark.parametrize("start,n_tok", [(0, 5), (6, 3)])
def test_attention_prefill_paged_kernel_switch(model, start, n_tok, kernel):
    """`test_attention_prefill_paged`'s cases through each side of the
    read's switch, `start` passed as the model passes it: "reference" (the
    plain gather, any device) and "cuda" (on CPU tensors the paged flash
    wrapper's plain version) both equal the reference's real rows."""
    jcfg, tcfg, ja, ta = _layer0(model)
    rng = np.random.default_rng(5)
    bs, S = 4, 8
    (jk, tk), (jv, tv) = _pools(rng, 12, bs, tcfg.n_kv_heads,
                                tcfg.resolved_head_dim)
    table = np.array([3, 8, 1, 0, 0], np.int32)
    q_pos = (start + np.arange(S)).astype(np.int32)
    jt, tt = _both(table)
    jq, tq = _both(q_pos)
    jx, tx = _both(_rand(rng, 1, S, tcfg.d_model))
    jo, jk2, jv2 = _jit(JL.attention_prefill_paged)(ja, jcfg, jx, jq, n_tok,
                                                    jk, jv, jt)
    to, tk2, tv2 = TL.attention_prefill_paged(ta, tcfg, tx, tq, n_tok,
                                              tk, tv, tt, kernel=kernel,
                                              start=start)
    _close(to[:, :n_tok], jo[:, :n_tok], ATTN_TOL)
    _close_pools(tk2, jk2)
    _close_pools(tv2, jv2)
