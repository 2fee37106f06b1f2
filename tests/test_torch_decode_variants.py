"""The port's fused, speculative and chunked ServeEngine paths against the
JAX ServeEngine with the same keyword arguments (the `fused`,
`speculative` and `chunked` rows of tests/test_decode_parity.py's PATHS),
float32 on the CPU, on reduced qwen3-1.7b with the reference's own weights
bridged over. The port's paged decode read defaults to "cuda", which runs
the kernel's plain version on CPU tensors (the reference's default there
is its dense-gather "reference").

Bars: greedy and seeded-sampled tokens identical, in both prefill modes;
the radix counters and the speculative and scheduler counters equal to
the reference's (both run the same host-side bookkeeping).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.sampler import SamplingParams as JaxSampling  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.sampler import SamplingParams  # noqa: E402
from _torch_parity import bridged_model  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

BS = 4
PATHS = {
    "fused": dict(kv_layout="paged", fused_tokens=4),
    "speculative": dict(kv_layout="paged", spec_tokens=3, drafter="ngram"),
    "chunked": dict(kv_layout="paged", scheduler="chunked", chunk_budget=3),
}
# tests/test_decode_parity.py's prompts (a shared repetitive prefix plus
# per-request tails: radix reuse, and real n-gram acceptances) and one
# that matches a cached page only in part (copy-on-write)
PROMPTS = [[3, 1, 4, 3, 1, 4, 3, 1], [3, 1, 4, 3, 7], [9, 10, 11, 12],
           [5, 5, 5, 5, 5, 5], [3, 1, 4, 3, 1, 4, 9, 9, 2]]
SAMPLERS = {
    "greedy": {},
    "temperature": dict(temperature=0.8, seed=11),
    "topk_topp": dict(temperature=0.7, top_k=5, top_p=0.9, seed=5),
}
CACHE = ("hits", "misses", "tokens_reused", "tokens_computed", "cow_copies",
         "inserts", "rollbacks", "tokens_rolled_back")
SPEC = ("dispatches", "tokens_drafted", "tokens_accepted", "tokens_emitted",
        "tokens_rolled_back")


@pytest.fixture(scope="module")
def model():
    return bridged_model("qwen3-1.7b")


def _kw(path, prefill_mode):
    return dict(PATHS[path], batch_slots=2, cache_len=32, block_size=BS,
                prefill_mode=prefill_mode)


def _serve(engine, sampling, prompts=PROMPTS):
    """Outputs, radix counters, speculative counters (the change over the
    run: the reference's `reset` keeps them) and scheduler counters."""
    spec0 = dict(engine.spec_metrics or {})
    reqs = [engine.submit(p, max_new_tokens=3 + 2 * i, sampling=sampling)
            for i, p in enumerate(prompts)]
    engine.run()
    for r in reqs:
        assert r.done and r.error is None
    m = engine.cache_metrics.as_dict()
    spec = engine.spec_metrics
    if spec is not None:
        spec = {k: spec[k] - spec0.get(k, 0) for k in SPEC}
    return ([r.output for r in reqs], {k: m[k] for k in CACHE}, spec,
            engine.scheduler_metrics)


_JAX_ENGINES = {}
_REFERENCE = {}


def _jax_engine(model, path, prefill_mode):
    """One JAX engine per (path, prefill mode), reset between uses: `reset`
    keeps the jitted steps, so each compiles once per module."""
    key = (path, prefill_mode)
    eng = _JAX_ENGINES.get(key)
    if eng is None:
        jcfg, _, jp, _ = model
        eng = _JAX_ENGINES[key] = JaxEngine(jp, jcfg,
                                            **_kw(path, prefill_mode))
    else:
        eng.reset()
        eng.set_degraded(False)
    return eng


def _reference(model, path, prefill_mode, sampler):
    key = (path, prefill_mode, sampler)
    if key not in _REFERENCE:
        _REFERENCE[key] = _serve(_jax_engine(model, path, prefill_mode),
                                 JaxSampling(**SAMPLERS[sampler]))
    return _REFERENCE[key]


def _engine(model, path, prefill_mode="decode", **kw):
    _, tcfg, _, tp = model
    return ServeEngine(tp, tcfg, **_kw(path, prefill_mode), device="cpu",
                       **kw)


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
@pytest.mark.parametrize("prefill_mode", ["decode", "bulk"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_engine_matches_jax_engine(model, path, prefill_mode, sampler):
    eng = _engine(model, path, prefill_mode)
    got = _serve(eng, SamplingParams(**SAMPLERS[sampler]))
    assert got == _reference(model, path, prefill_mode, sampler)
    eng.manager.check_invariants()
    kind = {"fused": "fused", "speculative": "spec", "chunked": "mixed"}
    if sampler == "greedy" or path == "chunked":
        assert kind[path] in eng.step_times
    if path == "speculative" and sampler == "greedy":
        # not vacuous: real acceptances, and real rollbacks of the rejects
        assert got[2]["tokens_accepted"] > 0
        assert got[2]["tokens_rolled_back"] > 0
        assert got[1]["rollbacks"] > 0


@pytest.mark.parametrize("path", ["fused", "speculative"])
def test_greedy_only_paths_fall_back_on_mixed_batch(model, path):
    """One sampled request in the batch drops the fused / speculative
    dispatch to single-token steps; greedy and seeded-sampled outputs
    match the JAX engine's on the same mixed batch, and the port's phased
    engine's."""
    jcfg, tcfg, jp, tp = model
    outs = {}
    for name, make, sampling in (
            ("jax", lambda: JaxEngine(jp, jcfg, **_kw(path, "decode")),
             JaxSampling),
            ("port", lambda: _engine(model, path), SamplingParams),
            ("phased", lambda: ServeEngine(
                tp, tcfg, batch_slots=2, cache_len=32, kv_layout="paged",
                block_size=BS, device="cpu"), SamplingParams)):
        eng = make()
        a = eng.submit(PROMPTS[0], max_new_tokens=6)              # greedy
        b = eng.submit(PROMPTS[1], max_new_tokens=6, sampling=sampling(
            temperature=0.7, top_k=7, seed=3))
        eng.run()
        outs[name] = [a.output, b.output]
        if name == "port":
            # the sampled request rode single steps until it retired
            assert "decode" in eng.step_times
    assert outs["port"] == outs["jax"] == outs["phased"]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_set_degraded_parks_the_lanes(model, path):
    """Brownout: the fused and speculative lanes are parked (single steps
    only) and chunks are capped at `chunk_cap`; outputs stay the JAX
    engine's under the same lever."""
    jeng = _jax_engine(model, path, "bulk")
    eng = _engine(model, path, "bulk")
    for e in (jeng, eng):
        e.set_degraded(True, chunk_cap=2)
    sampling = (JaxSampling(), SamplingParams())
    got = [_serve(e, s) for e, s in zip((jeng, eng), sampling)]
    assert got[1] == got[0]
    assert eng.degraded
    if path == "chunked":
        m = eng.scheduler_metrics
        assert m["chunk_cap"] == 2 and m["tokens_per_chunk"] <= 2
    else:
        assert "fused" not in eng.step_times and \
            "spec" not in eng.step_times
    eng.set_degraded(False)
    assert not eng.degraded
    if path == "chunked":
        assert eng.scheduler_metrics["chunk_cap"] is None


@pytest.mark.parametrize("path", sorted(PATHS))
def test_second_run_after_reset(model, path):
    """reset() rebuilds the pool, the radix index, the scheduler and the
    drafter's state (and, on the card, drops the fused graph): a second
    run serves the first run's tokens again, the reference's."""
    eng = _engine(model, path)
    first = _serve(eng, SamplingParams())
    eng.reset()
    assert not eng.has_work() and eng.cache_metrics.lookups == 0
    second = _serve(eng, SamplingParams())
    assert first[0] == second[0] == _reference(model, path, "decode",
                                               "greedy")[0]
    assert second[1] == first[1]
    if path == "chunked":
        assert second[3] == first[3]
    eng.manager.check_invariants()


def test_model_drafter_in_the_engine(model):
    """Speculation with a drafter that shares the target's weights (the
    port's `ModelDrafter` on the dense layout): every draft is accepted
    and the tokens are the phased engine's."""
    from repro_torch.serve.draft import ModelDrafter
    _, tcfg, _, tp = model
    phased = ServeEngine(tp, tcfg, batch_slots=2, cache_len=32,
                         kv_layout="paged", block_size=BS, device="cpu")
    want = _serve(phased, SamplingParams())[0]
    eng = ServeEngine(tp, tcfg, batch_slots=2, cache_len=32,
                      kv_layout="paged", block_size=BS, spec_tokens=3,
                      drafter=ModelDrafter(tp, tcfg, cache_len=64),
                      device="cpu")
    got = _serve(eng, SamplingParams())
    assert got[0] == want
    assert eng.spec_metrics["acceptance_rate"] == 1.0
    assert np.isclose(eng.spec_metrics["tokens_per_dispatch"],
                      got[2]["tokens_emitted"] / got[2]["dispatches"])


def test_fused_dispatch_runs_its_body_on_cpu(model):
    """On CPU tensors the fused dispatch is the eager body: no graph is
    captured and nothing is counted as a replay."""
    eng = _engine(model, "fused")
    _serve(eng, SamplingParams())
    graph = eng._decode_fused
    assert graph.replays == 0 and graph.warmup_runs == 0
    assert graph._graph is None
    assert eng.step_times["fused"].n > 0
    assert isinstance(eng.cache[0]["k"], torch.Tensor)


def test_tracing_records_the_variant_spans(model):
    """Each lane records its dispatch span after the port's
    `device.decode`: `device.fused`, `device.verify` (with the drafter's
    `draft`) and `device.mixed`, each inside an `engine.step` of its kind."""
    from repro_torch.obs import trace
    want = {"fused": {"device.fused"}, "speculative": {"device.verify",
                                                       "draft"},
            "chunked": {"device.mixed"}}
    for path, spans in want.items():
        eng = _engine(model, path)
        tracer = trace.enable()
        try:
            _serve(eng, SamplingParams())
        finally:
            assert trace.disable() is tracer
        names = {e["name"] for e in tracer.events() if e["ph"] == "X"}
        assert spans | {"engine.step", "engine.admit"} <= names, path
