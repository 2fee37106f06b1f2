"""The reference's per-architecture smoke tests (tests/test_arch_smoke.py)
on the port, over all ten `ARCH_IDS`: a reduced variant runs one forward,
one AdamW train step and one decode step, with shapes and finiteness
asserted as there, and each output held against the reference's on the
reference's own weights (bridged with `params_from_jax`); the full
configs carry the assigned hyper-parameters, field for field the
reference's. Then the three families this slice ports, through the whole
dense serving path: granite-moe (MoE FFN), seamless-m4t (encoder-decoder,
with `enc_embeds`) and pixtral (modality prefix, with `embeds`) run
`forward_prefill`, `prefill_into_cache` and greedy `decode_step`s against
the reference's; plus the reference's own prefix and cross-attention
cases of tests/test_models.py.

float32 on the CPU. Tolerance 1e-4 (a few layers of f32 sums in another
order); an MoE's aux values 1e-5.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils._pytree import tree_flatten, tree_map  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.step import prefill_into_cache as jax_prefill_into_cache  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.step import prefill_into_cache  # noqa: E402
from repro_torch.train.step import build_lm_train_step  # noqa: E402
from _torch_parity import assert_config_is_the_references  # noqa: E402
from _torch_parity import bridged_model, jax_layer_caches, to_np  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

B, S = 2, 32
TOL = 1e-4
FAMILIES = ["granite-moe-1b-a400m", "pixtral-12b", "seamless-m4t-large-v2"]


def _batch(cfg, seed=0, b=B, s=S):
    """tokens and labels, plus 16 encoder frames or an 8-row prefix (the
    reference's smoke shapes), as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.is_encdec:
        out["enc_embeds"] = rng.standard_normal((b, 16, cfg.d_model)) \
            .astype(np.float32)
    elif cfg.embed_stub:
        out["embeds"] = rng.standard_normal((b, 8, cfg.d_model)) \
            .astype(np.float32)
    return out


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(to_np(t), to_np(j), atol=tol, rtol=tol)


# ---- tests/test_arch_smoke.py on the port

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_reduced_forward_and_train_step(arch):
    jcfg, cfg, jp, tp = bridged_model(arch)
    assert cfg.d_model <= 512
    assert cfg.n_layers <= 3
    if cfg.moe:
        assert cfg.moe.n_experts <= 4
    batch = _batch(cfg)
    logits, aux = T.forward_train(tp, cfg, _t(batch))
    assert logits.shape == (B, S, cfg.vocab_size)
    assert np.isfinite(to_np(logits)).all()
    jlogits, jaux = JT.forward_train(jp, jcfg, _j(batch))
    _close(logits, jlogits)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), atol=1e-5)

    params = tree_map(torch.clone, tp)
    opt_init, opt_update = adamw(1e-3)
    step = build_lm_train_step(cfg, opt_update)
    p2, _, metrics = step(params, opt_init(params), _t(batch))
    assert np.isfinite(float(metrics["loss"]))
    # params actually changed
    delta = sum(float((a - b).abs().sum())
                for a, b in zip(tree_flatten(tp)[0], tree_flatten(p2)[0]))
    assert delta > 0


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_reduced_decode_step(arch):
    jcfg, cfg, jp, tp = bridged_model(arch)
    enc_len = 16 if cfg.is_encdec else 0
    cache = T.init_cache(cfg, B, 64, device="cpu", enc_len=enc_len)
    keys = [sorted(c) for c in cache]
    tok = torch.ones((B, 1), dtype=torch.int32)
    pos = torch.zeros((B,), dtype=torch.int32)
    logits, cache2 = T.decode_step(tp, cfg, tok, pos, cache)
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert np.isfinite(to_np(logits)).all()
    # cache structure is preserved
    assert [sorted(c) for c in cache2] == keys
    jcache = JT.init_cache(jcfg, B, 64, enc_len=enc_len)
    jlogits, _ = JT.decode_step(jp, jcfg, jnp.ones((B, 1), jnp.int32),
                                jnp.zeros((B,), jnp.int32), jcache)
    _close(logits, jlogits)
    assert [sorted(c) for c in jax_layer_caches(jcache, jcfg)] == keys


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_full_config_matches_the_reference(arch):
    """The full configs carry the exact assigned hyper-parameters: every
    field of the reference's, nested MoE/SSM/RG-LRU configs included, is
    the reference's, and every port-only field stands at its default."""
    assert_config_is_the_references(registry.get(arch), jreg.get(arch))


def test_arch_ids_are_the_references():
    assert registry.ARCH_IDS == jreg.ARCH_IDS and len(registry.ARCH_IDS) == 10


# ---- the families of this slice through the dense serving path

@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_reference(arch, impl):
    """forward_prefill's logits and caches (cross K/V included), the
    decode cache after `prefill_into_cache`, then four greedy decode steps
    from the reference's tokens: logits within 1e-4 at every step."""
    jcfg, cfg, jp, tp = bridged_model(arch)
    jcfg, cfg = (c.replace(attention_impl=impl) for c in (jcfg, cfg))
    batch = _batch(cfg, seed=1, s=12)
    batch.pop("labels")
    logits, nat = T.forward_prefill(tp, cfg, _t(batch))
    jlogits, jnat = JT.forward_prefill(jp, jcfg, _j(batch))
    assert logits.shape == (B, 12, cfg.vocab_size)
    _close(logits, jlogits)
    n = 12 + (8 if cfg.embed_stub else 0)
    enc_len = 16 if cfg.is_encdec else 0
    cache = prefill_into_cache(cfg, nat, T.init_cache(
        cfg, B, 32, device="cpu", enc_len=enc_len), torch.full((B,), n))
    jcache = jax_prefill_into_cache(jcfg, jnat, JT.init_cache(
        jcfg, B, 32, enc_len=enc_len), jnp.full((B,), n))
    for tl, jl in zip(cache, jax_layer_caches(jcache, jcfg)):
        assert set(tl) == set(jl)
        for k, v in jl.items():
            if "pos" in k:
                np.testing.assert_array_equal(tl[k].numpy(), v)
            else:
                _close(tl[k], v)
    tok = np.asarray(jnp.argmax(jlogits[:, -1:], -1)).astype(np.int32)
    for t in range(4):
        pos = np.full((B,), n + t, np.int32)
        lg, cache = T.decode_step(tp, cfg, torch.as_tensor(tok),
                                  torch.as_tensor(pos), cache)
        jlg, jcache = JT.decode_step(jp, jcfg, jnp.asarray(tok),
                                     jnp.asarray(pos), jcache)
        _close(lg, jlg)
        tok = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)


def test_encoder_matches_reference():
    jcfg, cfg, jp, tp = bridged_model("seamless-m4t-large-v2")
    enc = np.random.default_rng(2).standard_normal((B, 10, cfg.d_model)) \
        .astype(np.float32)
    out, pos = T._encode(tp, cfg, torch.as_tensor(enc))
    jout, jpos = JT._encode(jp, jcfg, jnp.asarray(enc))
    _close(out, jout)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


# ---- the reference's prefix and cross-attention cases of tests/test_models.py

V = 53


def test_vlm_prefix_does_not_shift_text_logits_shape():
    cfg = ModelConfig("v", "vlm", 2, 64, 4, 2, 128, V, embed_stub=True)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    b = {"tokens": torch.ones((2, 10), dtype=torch.int32),
         "embeds": torch.ones((2, 6, 64))}
    logits, _ = T.forward_train(params, cfg, b)
    assert logits.shape == (2, 10, V)             # text positions only


def test_encdec_cross_attention_sees_encoder():
    cfg = ModelConfig("e", "encdec", 2, 64, 4, 4, 128, V, n_enc_layers=2)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    toks = torch.ones((1, 8), dtype=torch.int32)
    l1, _ = T.forward_train(params, cfg, {"tokens": toks,
                                          "enc_embeds": torch.zeros(1, 4, 64)})
    l2, _ = T.forward_train(params, cfg, {"tokens": toks,
                                          "enc_embeds": torch.ones(1, 4, 64)})
    assert float((l1 - l2).abs().max()) > 1e-6
