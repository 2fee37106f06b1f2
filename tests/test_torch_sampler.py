"""The port's per-request sampler (repro_torch.serve.sampler, re-exported
as repro_torch.gateway.sampler) against the reference's.

  * the reference's unit cases of tests/test_sampler.py, on the port;
  * a differential case: seeded float32 and float64 logits of widths 41,
    64 and 151,936 (qwen3's vocabulary) go through both packages'
    `apply_top_k`, `apply_top_p`, `sample_token` and a 64-draw `Sampler`
    stream, in each of five modes (greedy, temperature, top-k, top-p,
    top-k with top-p), seeded and unseeded; the results must be equal bit
    for bit (an unseeded sampler's private generator is replaced by one
    seeded alike on both sides, as the engine hands `sample_token` the
    request's own generator);
  * both of the port's import paths give the same objects;
  * the reference's three engine cases on the port's ServeEngine (CPU),
    on the dense and the paged KV layout, each also held to the JAX
    engine's tokens on the same weights (the reference's draw, bridged),
    greedy and seeded-sampled.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from _torch_host import one_torch_thread  # noqa: E402,F401
from _torch_tiny import (BS, jax_engine, outputs, port_engine,  # noqa: E402
                         tiny)
from repro.gateway import sampler as jsampler  # noqa: E402
from repro_torch.gateway import sampler as gsampler  # noqa: E402
from repro_torch.gateway.sampler import (GREEDY, Sampler,  # noqa: E402
                                         SamplingParams, apply_top_k,
                                         apply_top_p, sample_token)
from repro_torch.serve import sampler as ssampler  # noqa: E402

JSamplingParams = jsampler.SamplingParams


# ----------------------------------------------------------------- unit

def test_temperature_zero_is_argmax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        logits = rng.normal(size=64)
        assert sample_token(logits, GREEDY) == int(np.argmax(logits))
        # tiny temperatures stay greedy too (<= 0 convention)
        assert sample_token(logits, SamplingParams(temperature=0.0)) == \
            int(np.argmax(logits))


def test_top_k_masks_all_but_k():
    logits = np.asarray([0.1, 3.0, -1.0, 2.0, 0.5])
    masked = apply_top_k(logits, 2)
    kept = np.flatnonzero(np.isfinite(masked))
    assert set(kept) == {1, 3}                    # two highest logits
    assert np.all(masked[kept] == logits[kept])   # kept values unchanged
    # k >= V is a no-op
    assert np.array_equal(apply_top_k(logits, 5), logits)


def test_top_k_sampling_never_leaves_top_k():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=32)
    top3 = set(np.argsort(logits)[-3:])
    params = SamplingParams(temperature=1.5, top_k=3, seed=123)
    s = Sampler(params)
    draws = {s.sample(logits) for _ in range(200)}
    assert draws <= top3
    assert len(draws) > 1          # actually stochastic, not argmax


def test_top_p_keeps_minimal_nucleus():
    probs = np.asarray([0.5, 0.3, 0.15, 0.05])
    out = apply_top_p(probs, 0.75)
    assert out[2] == 0.0 and out[3] == 0.0        # outside the nucleus
    np.testing.assert_allclose(out[:2], [0.5 / 0.8, 0.3 / 0.8])
    np.testing.assert_allclose(out.sum(), 1.0)
    # p=1 is a no-op; extreme p keeps at least the argmax
    assert np.array_equal(apply_top_p(probs, 1.0), probs)
    tiny_p = apply_top_p(probs, 1e-9)
    assert tiny_p[0] == 1.0


def test_fixed_seed_reproducible_stream():
    rng = np.random.default_rng(2)
    logit_rows = [rng.normal(size=16) for _ in range(10)]
    p = SamplingParams(temperature=0.9, top_k=8, seed=77)
    a = Sampler(p)
    b = Sampler(p)
    toks_a = [a.sample(lg) for lg in logit_rows]
    toks_b = [b.sample(lg) for lg in logit_rows]
    assert toks_a == toks_b
    # a replica-failure retry rebuilds the Request, whose fresh Sampler
    # rewinds the stream — re-seeding must reproduce it even after use
    c = Sampler(p)
    c.sample(logit_rows[0])
    rewound = Sampler(c.params)
    assert [rewound.sample(lg) for lg in logit_rows] == toks_a
    # a different seed gives a different stream (overwhelmingly likely)
    d = Sampler(SamplingParams(temperature=0.9, top_k=8, seed=78))
    assert [d.sample(lg) for lg in logit_rows] != toks_a


# ----------------------------------------------- differential: the math

MODES = {"greedy": dict(),
         "temperature": dict(temperature=0.7),
         "top_k": dict(temperature=1.3, top_k=20),
         "top_p": dict(temperature=0.9, top_p=0.8),
         "top_k_top_p": dict(temperature=1.1, top_k=40, top_p=0.6)}
N_DRAWS = 64


def _same(a, b):
    """Bit for bit: same dtype, same shape, same values (-inf included)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a, b)


def _stream(pkg, params_cls, kw, seed, logits):
    """A Sampler's 64 draws over fresh rows of `logits`. Unseeded, its
    private generator is replaced by one seeded alike on both sides."""
    s = pkg.Sampler(params_cls(**kw, seed=seed))
    if seed is None:
        s._rng = np.random.default_rng(12345)
    return [s.sample(row) for row in logits]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("width", [41, 64, 151_936])
def test_sampler_matches_reference(width, dtype):
    rng = np.random.default_rng(width)
    rows = (rng.standard_normal((N_DRAWS, width)) * 3).astype(dtype)
    row = rows[0]
    argmax = [int(np.argmax(r)) for r in rows]
    for k in (1, 5, 20, width - 1, width):
        assert _same(gsampler.apply_top_k(row, k),
                     jsampler.apply_top_k(row, k))
    for probs in (np.exp(row - row.max()),
                  np.exp(row.astype(np.float64) - row.max())):
        probs = probs / probs.sum()
        for p in (1e-9, 0.3, 0.8, 0.999, 1.0):
            assert _same(gsampler.apply_top_p(probs, p),
                         jsampler.apply_top_p(probs, p))
    for mode, kw in MODES.items():
        for seed in (7, None):
            tp, jp = SamplingParams(**kw, seed=seed), \
                JSamplingParams(**kw, seed=seed)
            assert tp.to_payload() == jp.to_payload()
            one = [gsampler.sample_token(r, tp, np.random.default_rng(3))
                   for r in rows[:4]]
            assert one == [jsampler.sample_token(r, jp,
                                                 np.random.default_rng(3))
                           for r in rows[:4]], (mode, seed)
            port = _stream(gsampler, SamplingParams, kw, seed, rows)
            ref = _stream(jsampler, JSamplingParams, kw, seed, rows)
            assert port == ref, (mode, seed)
            # greedy is the argmax; every other mode really drew
            assert (port == argmax) == (mode == "greedy"), (mode, seed)


def test_both_import_paths_give_the_same_objects():
    for name in gsampler.__all__:
        assert getattr(gsampler, name) is getattr(ssampler, name), name
    assert set(gsampler.__all__) == set(jsampler.__all__)


# --------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def model():
    return tiny()


def _engines(model, kv, **kw):
    """A port engine and a JAX engine on the same weights and layout."""
    kw = dict(kw, cache_len=64, kv_layout=kv)
    if kv == "paged":
        kw["block_size"] = BS
    return port_engine(model, **kw), jax_engine(model, **kw)


KV = ["dense", "paged"]


@pytest.mark.parametrize("kv", KV)
def test_engine_greedy_default_unchanged(model, kv):
    """No SamplingParams decodes as temperature 0 does, in the port and
    in the JAX engine alike."""
    outs = []
    for sampling in (None, SamplingParams(temperature=0.0)):
        port, ref = _engines(model, kv, batch_slots=1)
        out = outputs(port, [[3, 1, 4, 1, 5]], max_new=5,
                      sampling=sampling)
        jsamp = None if sampling is None else JSamplingParams(0.0)
        assert out == outputs(ref, [[3, 1, 4, 1, 5]], max_new=5,
                              sampling=jsamp)
        outs.append(out)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kv", KV)
def test_two_slots_sample_independently_in_one_batch(model, kv):
    """A seeded stochastic request decodes identically whether it shares the
    lockstep batch with a greedy peer or runs alone — and the greedy peer is
    untouched by its neighbour's sampling. Each output equals the JAX
    engine's."""
    kw = dict(temperature=0.8, top_k=12, seed=42)
    stoch, jstoch = SamplingParams(**kw), JSamplingParams(**kw)
    solo = {}
    for name, sampling, jsampling in (("greedy", None, None),
                                      ("stoch", stoch, jstoch)):
        port, ref = _engines(model, kv, batch_slots=1)
        solo[name] = outputs(port, [[5, 6, 7]], max_new=6,
                             sampling=sampling)[0]
        assert solo[name] == outputs(ref, [[5, 6, 7]], max_new=6,
                                     sampling=jsampling)[0]
    both = {}
    for side, (eng, samp) in zip(("port", "ref"),
                                 zip(_engines(model, kv, batch_slots=2),
                                     (stoch, jstoch))):
        rg = eng.submit([5, 6, 7], max_new_tokens=6)
        rs = eng.submit([5, 6, 7], max_new_tokens=6, sampling=samp)
        eng.run()
        both[side] = (rg.output, rs.output)
    assert both["port"] == (solo["greedy"], solo["stoch"])
    assert both["ref"] == both["port"]
    assert solo["stoch"] != solo["greedy"]       # the sampler really drew


@pytest.mark.parametrize("kv", KV)
def test_prefill_eos_not_emitted(model, kv):
    """If the very first token out of prefill is EOS, it must not be
    appended to the output (the pre-gateway engine emitted it)."""
    port, ref = _engines(model, kv, batch_slots=1)
    probe = outputs(port, [[3, 1, 4, 1, 5]], max_new=1)[0]
    assert probe == outputs(ref, [[3, 1, 4, 1, 5]], max_new=1)[0]
    eos = probe[0]
    for eng in _engines(model, kv, batch_slots=1):
        r = eng.submit([3, 1, 4, 1, 5], max_new_tokens=8, eos_id=eos)
        done = eng.run()
        assert r in done and r.done
        assert r.output == []          # EOS swallowed, no budget burned
