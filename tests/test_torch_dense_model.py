"""The port's dense-layout model functions against the reference's,
float32 on the CPU, with the reference's own weights bridged over:
`forward_prefill`, `init_cache`, `prefill_into_cache` and `decode_step`
on reduced qwen3-1.7b, reduced recurrentgemma-9b (one r, r, a block,
window 16) and reduced mamba2-130m (two ssm layers, chunk 16), under both
`attention_impl` values, plus a hybrid with a tail (`reduce_config` drops
recurrentgemma's) and a ring cache.

Tolerance 1e-4 for logits and caches: a few layers of f32 sums taken in
another order. Positions in the caches must be equal.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.configs.base import RGLRUConfig as JaxRGLRU  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.step import prefill_into_cache as jax_prefill_into_cache  # noqa: E402
from repro_torch.configs.base import ModelConfig, RGLRUConfig  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serve.step import prefill_into_cache  # noqa: E402
from _torch_parity import bridged_model, jax_layer_caches, to_np  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

TOL = 1e-4
V = 97
# a hybrid with the tail that reduce_config drops: blocks r, r, a then
# r, r; window 8
TAIL_KW = dict(arch_id="h", family="hybrid", n_layers=5, d_model=64,
               n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=V,
               block_pattern=("rglru", "rglru", "attn"),
               tail_pattern=("rglru", "rglru"), window=8)


def _tail_model():
    jcfg = JaxConfig(**TAIL_KW, rglru=JaxRGLRU(lru_width=64))
    tcfg = ModelConfig(**TAIL_KW, rglru=RGLRUConfig(lru_width=64))
    jp = jax.jit(JT.init_lm, static_argnums=1)(jax.random.PRNGKey(4), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


MODELS = {"qwen3-1.7b": lambda: bridged_model("qwen3-1.7b"),
          "recurrentgemma-9b": lambda: bridged_model("recurrentgemma-9b"),
          "mamba2-130m": lambda: bridged_model("mamba2-130m"),
          "hybrid-tail": _tail_model}
_BUILT = {}


def _model(name, impl, jax_impl=None):
    """(jax cfg, torch cfg, jax params, torch params) with attention_impl
    `impl` on both sides, or `jax_impl` on the reference's."""
    if name not in _BUILT:
        _BUILT[name] = MODELS[name]()
    jcfg, tcfg, jp, tp = _BUILT[name]
    return (jcfg.replace(attention_impl=jax_impl or impl),
            tcfg.replace(attention_impl=impl), jp, tp)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(to_np(t), to_np(j), atol=tol, rtol=tol)


def _caches_close(tcache, jcache, jcfg):
    for tl, jl in zip(tcache, jax_layer_caches(jcache, jcfg)):
        assert set(tl) == set(jl)
        for k, v in jl.items():
            if k == "pos":
                np.testing.assert_array_equal(tl[k].numpy(), v)
            else:
                _close(tl[k], v)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_into_cache_then_decode(name, impl):
    """A right-padded batch prefill (row 1 is shorter: its pad positions
    must get pos -1), its caches copied into a decode cache smaller than
    the prompt (a ring), then lockstep decode steps; logits and every
    cache leaf against the reference's. The reference's Pallas SSD route
    refuses Mamba2's 20-token prompt (not a multiple of the chunk, 16:
    ROADMAP.md Queue 3), so there the port's "pallas" is held against the
    reference's "xla"."""
    jax_impl = "xla" if name == "mamba2-130m" else None
    jcfg, tcfg, jp, tp = _model(name, impl, jax_impl)
    rng = np.random.default_rng(0)
    B, S, Sc = 2, 20, 16
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([S, S - 3])
    jl, jnat = jax.jit(JT.forward_prefill, static_argnums=1)(
        jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tnat = TT.forward_prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    _close(tl, jl)
    _caches_close(tnat, jnat, jcfg)
    jcache = jax.jit(jax_prefill_into_cache, static_argnums=0)(
        jcfg, jnat, JT.init_cache(jcfg, B, Sc), jnp.asarray(lens))
    tcache = prefill_into_cache(tcfg, tnat,
                                TT.init_cache(tcfg, B, Sc, device="cpu"),
                                lens)
    _caches_close(tcache, jcache, jcfg)
    jdec = jax.jit(JT.decode_step, static_argnums=1)
    pos = lens.astype(np.int32)
    for _ in range(3):
        t = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = jdec(jp, jcfg, jnp.asarray(t), jnp.asarray(pos), jcache)
        tl, tcache = TT.decode_step(tp, tcfg, torch.as_tensor(t),
                                    torch.as_tensor(pos), tcache)
        _close(tl, jl)
        pos += 1
    _caches_close(tcache, jcache, jcfg)


def test_init_cache_matches_reference():
    for name in sorted(MODELS):
        jcfg, tcfg, _, _ = _model(name, "xla")
        tcache = TT.init_cache(tcfg, 3, 8, device="cpu")
        jcache = jax_layer_caches(JT.init_cache(jcfg, 3, 8), jcfg)
        assert len(tcache) == len(jcache) == tcfg.n_layers
        for tl, jl in zip(tcache, jcache):
            for k, v in jl.items():
                assert tuple(tl[k].shape) == v.shape
                assert str(tl[k].dtype).split(".")[-1] == v.dtype.name
                np.testing.assert_array_equal(tl[k].numpy(), v)


def test_decode_rows_leave_other_rows_untouched():
    """decode_step(rows=...) writes only those rows' K/V, positions and
    recurrent state; the rows it writes match a step over every row."""
    _, tcfg, _, tp = _model("recurrentgemma-9b", "xla")
    rng = np.random.default_rng(1)
    cache = TT.init_cache(tcfg, 3, 8, device="cpu")
    for c in cache:                      # a live-looking cache
        for k, v in c.items():
            v.copy_(torch.as_tensor(rng.integers(0, 5, v.shape))
                    .to(v.dtype))
    full = [{k: v.clone() for k, v in c.items()} for c in cache]
    toks = torch.as_tensor(rng.integers(0, V, (3, 1)).astype(np.int32))
    pos = torch.tensor([5, 0, 9], dtype=torch.int32)
    before = [{k: v.clone() for k, v in c.items()} for c in cache]
    rows = torch.tensor([0, 2])
    lg, cache = TT.decode_step(tp, tcfg, toks, pos, cache, rows=rows)
    lg_full, full = TT.decode_step(tp, tcfg, toks, pos, full)
    for c, b, f in zip(cache, before, full):
        for k in c:
            assert torch.equal(c[k][1], b[k][1])
            assert torch.equal(c[k][rows], f[k][rows])
    assert torch.equal(lg[rows], lg_full[rows])


def test_ring_cache_decode_matches_linear():
    """A window-sized ring cache gives the same logits as a full cache for
    a windowed model (tests/test_models.py's ring case), and both match
    the reference's ring decode."""
    jcfg, tcfg, jp, tp = _model("hybrid-tail", "xla")
    B, S = 1, 24
    toks = np.random.default_rng(2).integers(0, V, (B, S)).astype(np.int32)
    full = TT.init_cache(tcfg, B, S, device="cpu")
    ring = TT.init_cache(tcfg, B, tcfg.window, device="cpu")
    jring = JT.init_cache(jcfg, B, jcfg.window)
    jdec = jax.jit(JT.decode_step, static_argnums=1)
    for t in range(S):
        tok = torch.as_tensor(toks[:, t:t + 1])
        pos = torch.full((B,), t, dtype=torch.int32)
        lf, full = TT.decode_step(tp, tcfg, tok, pos, full)
        lr, ring = TT.decode_step(tp, tcfg, tok, pos, ring)
        jl, jring = jdec(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                         jnp.full((B,), t, jnp.int32), jring)
        _close(lr, lf)
        _close(lr, jl)


def test_unported_families_refuse_loudly():
    """MoE, enc-dec and modality-prefix models raise, naming their ROADMAP
    item, rather than running another way. (Mamba2 is ported: its cases
    run in the tests above.)"""
    from repro_torch.configs.base import MoEConfig
    base = dict(arch_id="x", family="x", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=V)
    for kw in (dict(moe=MoEConfig(4, 2, 32)), dict(n_enc_layers=2),
               dict(embed_stub=True)):
        cfg = ModelConfig(**base, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TT.init_cache(cfg, 1, 8, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TT.param_shapes(cfg)


def test_step_builders_read_the_right_position():
    """build_prefill reads the last column, build_prefill_bucketed the
    last real one (n_tok - 1) of a right-padded batch, build_decode the
    decode step's only position; the greedy variants argmax the same
    logits."""
    from repro_torch.serve import step as S
    _, tcfg, _, tp = _model("qwen3-1.7b", "xla")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32))
    logits, _ = TT.forward_prefill(tp, tcfg, {"tokens": toks})
    last, _ = S.build_prefill(tcfg, return_logits=True)(tp, {"tokens": toks})
    tok, _ = S.build_prefill(tcfg)(tp, {"tokens": toks})
    assert torch.equal(last, logits[:, -1])
    assert torch.equal(tok, logits[:, -1].argmax(-1).to(torch.int32))
    lg5, _ = S.build_prefill_bucketed(tcfg, return_logits=True)(
        tp, {"tokens": toks}, 5)
    assert torch.equal(lg5, logits[:, 4])
    cache = TT.init_cache(tcfg, 2, 16, device="cpu")
    pos = torch.zeros((2,), dtype=torch.int32)
    dl, _ = S.build_decode(tcfg, return_logits=True)(tp, toks[:, :1], pos,
                                                     cache)
    cache = TT.init_cache(tcfg, 2, 16, device="cpu")
    dt, _ = S.build_decode(tcfg)(tp, toks[:, :1], pos, cache)
    assert torch.equal(dt, dl.argmax(-1).to(torch.int32))
    _close(dl, logits[:, 0])
