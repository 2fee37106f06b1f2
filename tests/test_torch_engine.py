"""The port's paged ServeEngine against the JAX ServeEngine(kv_layout=
"paged"), float32 on the CPU, on reduced qwen3-1.7b with the reference's
own weights bridged over.

Bars (ROADMAP.md): greedy tokens identical, seeded sampled tokens
identical, and `decode_step_paged` / `forward_prefill_paged` logits within
1e-4 (two layers of f32 sums taken in another order; the sampled streams
stay identical because the host sampler draws from float64 probabilities
that move by ~1e-6). The radix counters (hits, reused tokens, CoW copies)
must match the reference's exactly: both run the same host-side manager.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.sampler import SamplingParams as JaxSampling  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.sampler import SamplingParams  # noqa: E402
from _torch_parity import (bridged_model, jax_pools, to_np,  # noqa: E402
                           torch_pools)
from _torch_parity import one_torch_thread  # noqa: E402,F401

BS = 4
LOGIT_TOL = 1e-4
# tests/test_decode_parity.py's prompts (a shared repetitive prefix plus
# per-request tails), and one more that matches a cached page only in
# part, so admission copies it on write
PROMPTS = [[3, 1, 4, 3, 1, 4, 3, 1], [3, 1, 4, 3, 7], [9, 10, 11, 12],
           [5, 5, 5, 5, 5, 5], [3, 1, 4, 3, 1, 4, 9, 9, 2]]
SAMPLERS = {
    "greedy": {},
    "temperature": dict(temperature=0.8, seed=11),
    "topk_topp": dict(temperature=0.7, top_k=5, top_p=0.9, seed=5),
}
METRICS = ("hits", "misses", "tokens_reused", "tokens_computed",
           "cow_copies", "inserts", "blocks_evicted")


@pytest.fixture(scope="module")
def model():
    return bridged_model("qwen3-1.7b")


def _serve(engine, sampling):
    reqs = [engine.submit(p, max_new_tokens=3 + 2 * i, sampling=sampling)
            for i, p in enumerate(PROMPTS)]
    engine.run()
    for r in reqs:
        assert r.done and r.error is None
    m = engine.cache_metrics.as_dict()
    return [r.output for r in reqs], {k: m[k] for k in METRICS}


_JAX_ENGINES = {}
_REFERENCE = {}


def _jax_engine(model, prefill_mode="decode"):
    """One JAX paged engine per prefill mode, reset between uses: `reset`
    keeps the jitted steps, so each compiles once per module."""
    eng = _JAX_ENGINES.get(prefill_mode)
    if eng is None:
        jcfg, _, jp, _ = model
        eng = _JAX_ENGINES[prefill_mode] = JaxEngine(
            jp, jcfg, batch_slots=2, cache_len=32, kv_layout="paged",
            block_size=BS, prefill_mode=prefill_mode)
    else:
        eng.reset()
    return eng


def _reference(model, prefill_mode, sampler):
    """The JAX engine's outputs and counters, once per (mode, sampler)."""
    key = (prefill_mode, sampler)
    if key not in _REFERENCE:
        _REFERENCE[key] = _serve(_jax_engine(model, prefill_mode),
                                 JaxSampling(**SAMPLERS[sampler]))
    return _REFERENCE[key]


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
@pytest.mark.parametrize("decode_kernel", ["reference", "cuda"])
@pytest.mark.parametrize("prefill_mode", ["decode", "bulk"])
def test_engine_matches_jax_engine(model, prefill_mode, decode_kernel,
                                   sampler):
    _, tcfg, _, tp = model
    eng = ServeEngine(tp, tcfg, batch_slots=2, cache_len=32,
                      kv_layout="paged", block_size=BS,
                      prefill_mode=prefill_mode, decode_kernel=decode_kernel,
                      device="cpu")
    outs, metrics = _serve(eng, SamplingParams(**SAMPLERS[sampler]))
    ref_outs, ref_metrics = _reference(model, prefill_mode, sampler)
    assert outs == ref_outs
    assert metrics == ref_metrics
    assert metrics["hits"] > 0 and metrics["cow_copies"] > 0
    eng.manager.check_invariants()


def test_prefill_and_decode_logits_match(model):
    """Model level: a bulk suffix prefill on top of a resident prefix, then
    lockstep decode steps with one empty slot, through both stacks; the
    logits agree within 1e-4 and the pools (null block aside) too."""
    jcfg, tcfg, jp, tp = model
    nb, P = 6, 13
    jcache = JT.init_paged_cache(jcfg, P, BS)
    tcache = TT.init_paged_cache(tcfg, P, BS, device="cpu")
    table = np.zeros((3, nb), np.int32)
    table[0] = [4, 9, 2, 7, 0, 0]
    table[2] = [1, 3, 5, 6, 8, 10]
    rng = np.random.default_rng(0)
    jpre = jax.jit(JT.forward_prefill_paged, static_argnums=1)
    jdec = jax.jit(JT.decode_step_paged, static_argnums=1,
                   static_argnames="kernel")
    # slot 0: 10 prompt tokens in two prefills (the second reuses the first)
    for slot, (start, n, S) in ((0, (0, 6, 8)), (0, (6, 4, 4)),
                                (2, (0, 9, 16))):
        toks = np.zeros((1, S), np.int32)
        toks[0, :n] = rng.integers(0, tcfg.vocab_size, n)
        jl, jcache = jpre(jp, jcfg, jnp.asarray(toks), start, n, jcache,
                          jnp.asarray(table[slot]))
        tl, tcache = TT.forward_prefill_paged(
            tp, tcfg, torch.as_tensor(toks), start, n, tcache,
            torch.as_tensor(table[slot]))
        np.testing.assert_allclose(to_np(tl)[:, :n], to_np(jl)[:, :n],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    pos = np.array([10, 0, 9], np.int32)
    for _ in range(4):
        toks = rng.integers(0, tcfg.vocab_size, (3, 1)).astype(np.int32)
        jl, jcache = jdec(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                          jcache, jnp.asarray(table), kernel="reference")
        tl, tcache = TT.decode_step_paged(
            tp, tcfg, torch.as_tensor(toks), torch.as_tensor(pos), tcache,
            torch.as_tensor(table), kernel="cuda")
        live = [0, 2]
        np.testing.assert_allclose(to_np(tl)[live], to_np(jl)[live],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        pos[live] += 1
    for (tk, tv), (jk, jv) in zip(torch_pools(tcache),
                                  jax_pools(jcache, tcfg.n_layers)):
        np.testing.assert_allclose(tk[1:], jk[1:], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        np.testing.assert_allclose(tv[1:], jv[1:], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_unported_paths_refuse_loudly(model):
    _, tcfg, _, tp = model
    base = dict(batch_slots=2, cache_len=32, block_size=BS, device="cpu")
    for kw in (dict(kv_layout="paged", fused_tokens=4),
               dict(kv_layout="paged", spec_tokens=2),
               dict(kv_layout="paged", scheduler="chunked")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServeEngine(tp, tcfg, **base, **kw)
    with pytest.raises(ValueError, match="decode_kernel"):
        ServeEngine(tp, tcfg, kv_layout="paged", decode_kernel="pallas",
                    **base)
    with pytest.raises(ValueError, match="params are on"):
        ServeEngine(tp, tcfg, kv_layout="paged", batch_slots=2,
                    cache_len=32, block_size=BS, device="meta")


def test_gateway_surface(model):
    """The members the reference gateway duck-types exist and behave like
    the reference engine's on the same traffic."""
    _, tcfg, _, tp = model
    engines = [_jax_engine(model),
               ServeEngine(tp, tcfg, batch_slots=2, cache_len=32,
                           kv_layout="paged", block_size=BS, device="cpu")]
    seen = []
    for eng in engines:
        a = eng.submit(PROMPTS[0], max_new_tokens=4)
        b = eng.submit(PROMPTS[1], max_new_tokens=4)
        c = eng.submit(PROMPTS[2], max_new_tokens=4)
        row = [eng.free_slots(), eng.pending_count(), eng.has_work(),
               eng.token_capacity(), eng.free_token_capacity()]
        eng.step()
        row += [eng.active_count(), eng.pending_count(),
                eng.cached_prefix_tokens(PROMPTS[0]), eng.evict(b),
                eng.evict(c), eng.active_count()]
        eng.set_degraded(True)
        eng.run()
        row += [a.output, eng.spec_metrics, eng.scheduler_metrics,
                sorted(eng.step_times), eng.ledger]
        eng.reset()
        row += [eng.has_work(), eng.cache_metrics.lookups,
                eng.free_token_capacity()]
        seen.append(row)
    assert seen[0] == seen[1]


def test_tracing_records_the_engine_spans(model):
    """The port's copy of the span tracer: the engine's admit / step /
    device-dispatch / retire spans land in the ring while tracing is on
    (`fence` is a no-op for CPU tensors), and nothing is recorded off."""
    from repro_torch.obs import trace
    _, tcfg, _, tp = model
    eng = ServeEngine(tp, tcfg, batch_slots=2, cache_len=32,
                      kv_layout="paged", block_size=BS, device="cpu")
    tracer = trace.enable()
    try:
        eng.submit(PROMPTS[0], max_new_tokens=3)
        eng.run()
    finally:
        assert trace.disable() is tracer
    names = {e["name"] for e in tracer.events() if e["ph"] == "X"}
    assert {"engine.admit", "engine.step", "device.decode",
            "engine.retire"} <= names
    n = tracer.recorded
    eng.submit(PROMPTS[1], max_new_tokens=2)
    eng.run()
    assert tracer.recorded == n
