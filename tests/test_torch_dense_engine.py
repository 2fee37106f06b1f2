"""The port's dense-layout ServeEngine against the JAX ServeEngine(kv_layout=
"dense"), float32 on the CPU, with the reference's own weights bridged
over: reduced qwen3-1.7b, reduced recurrentgemma-9b and reduced
mamba2-130m, both prefill modes, both `attention_impl` values,
tests/test_decode_parity.py's prompts and samplers.

Bars (ROADMAP.md): greedy and seeded-sampled tokens identical. Two
properties of the port on top: admitting a request never disturbs a live
peer's decode, and a slot starts every request from a clean state. The
second is where the port parts from the reference, whose decode-mode
prefill keeps the previous request's recurrent state (RG-LRU or SSM) in a
reused slot (ROADMAP.md Queue 3): the recurrent decode-mode cells
therefore run with a slot per request, where no slot is reused. A third:
the port's "pallas" route serves a Mamba2 prompt that is not a multiple of
the SSD chunk, which the reference's Pallas route refuses (Queue 3); it
matches the reference's "xla" route there.
"""
import pytest

jax = pytest.importorskip("jax")

from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.sampler import SamplingParams as JaxSampling  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.sampler import SamplingParams  # noqa: E402
from _torch_parity import bridged_model  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = ["qwen3-1.7b", "recurrentgemma-9b", "mamba2-130m"]
RECURRENT = ("recurrentgemma-9b", "mamba2-130m")
PROMPTS = [[3, 1, 4, 3, 1, 4, 3, 1], [3, 1, 4, 3, 7], [9, 10, 11, 12],
           [5, 5, 5, 5, 5, 5]]
SAMPLERS = {
    "greedy": {},
    "temperature": dict(temperature=0.8, seed=11),
    "topk_topp": dict(temperature=0.7, top_k=5, top_p=0.9, seed=5),
}
CACHE_LEN = 32


def _model(arch, impl):
    jcfg, tcfg, jp, tp = bridged_model(arch)
    return (jcfg.replace(attention_impl=impl),
            tcfg.replace(attention_impl=impl), jp, tp)


def _slots(arch, prefill_mode):
    return len(PROMPTS) if (arch in RECURRENT
                            and prefill_mode == "decode") else 2


def _serve(engine, sampling, prompts=PROMPTS):
    reqs = [engine.submit(p, max_new_tokens=3 + 2 * i, sampling=sampling)
            for i, p in enumerate(prompts)]
    engine.run()
    for r in reqs:
        assert r.done and r.error is None
    return [r.output for r in reqs]


_JAX_ENGINES = {}
_REFERENCE = {}


def _jax_engine(arch, impl, prefill_mode, slots):
    """One JAX dense engine per configuration, reset between uses: `reset`
    keeps the jitted steps, so each compiles once per module."""
    key = (arch, impl, prefill_mode, slots)
    eng = _JAX_ENGINES.get(key)
    if eng is None:
        jcfg, _, jp, _ = _model(arch, impl)
        eng = _JAX_ENGINES[key] = JaxEngine(
            jp, jcfg, batch_slots=slots, cache_len=CACHE_LEN,
            prefill_mode=prefill_mode)
    else:
        eng.reset()
    return eng


def _reference(arch, impl, prefill_mode, sampler):
    if prefill_mode == "decode":
        # decode steps reach neither kernel (flash attention and the scan
        # serve full sequences only), so both impls run the same JAX
        # computation: compile it once
        impl = "xla"
    key = (arch, impl, prefill_mode, sampler)
    if key not in _REFERENCE:
        eng = _jax_engine(arch, impl, prefill_mode,
                          _slots(arch, prefill_mode))
        _REFERENCE[key] = _serve(eng, JaxSampling(**SAMPLERS[sampler]))
    return _REFERENCE[key]


def _engine(arch, impl, prefill_mode, slots):
    _, tcfg, _, tp = _model(arch, impl)
    return ServeEngine(tp, tcfg, batch_slots=slots, cache_len=CACHE_LEN,
                       prefill_mode=prefill_mode, device="cpu")


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("prefill_mode", ["decode", "bulk"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch, prefill_mode, impl, sampler):
    eng = _engine(arch, impl, prefill_mode, _slots(arch, prefill_mode))
    assert eng.kv_layout == "dense" and eng.cache_metrics is None
    outs = _serve(eng, SamplingParams(**SAMPLERS[sampler]))
    assert outs == _reference(arch, impl, prefill_mode, sampler)


@pytest.mark.parametrize("arch", ARCHS)
def test_admission_leaves_a_live_peer_alone(arch):
    """A request admitted in decode-mode prefill while another slot is
    mid-decode: every prefill step runs the whole batch, but writes only
    the new slot's cache rows, so the peer's tokens equal those of a run
    where it is alone."""
    peer, late = [3, 1, 4, 3, 1, 4, 3, 1], [9, 10, 11, 12, 13, 14]
    alone = _engine(arch, "pallas", "decode", 2)
    a = alone.submit(peer, max_new_tokens=10)
    alone.run()
    eng = _engine(arch, "pallas", "decode", 2)
    p = eng.submit(peer, max_new_tokens=10)
    for _ in range(4):
        eng.step()
    assert 1 < len(p.output) < 10
    q = eng.submit(late, max_new_tokens=4)
    eng.run()
    assert p.output == a.output
    assert q.done and len(q.output) == 4


def _check_reused_slot_starts_clean(arch):
    def second(eng, sampling):
        first = eng.submit(PROMPTS[0], max_new_tokens=3, sampling=sampling)
        later = eng.submit(PROMPTS[1], max_new_tokens=5, sampling=sampling)
        eng.run()
        assert first.done and later.done
        return later.output

    alone = _engine(arch, "xla", "decode", 1)
    r = alone.submit(PROMPTS[1], max_new_tokens=5)
    alone.run()
    outs = [second(_engine(arch, "xla", mode, 1), SamplingParams())
            for mode in ("decode", "bulk")]
    jax_bulk = second(_jax_engine(arch, "xla", "bulk", 1), JaxSampling())
    assert outs[0] == outs[1] == r.output == jax_bulk


def test_reused_slot_starts_clean():
    """One slot serving two requests in turn: the second request's tokens
    do not depend on the first, in decode-mode prefill as in bulk, and
    equal the JAX engine's bulk-mode tokens."""
    _check_reused_slot_starts_clean("recurrentgemma-9b")


def test_reused_slot_starts_clean_mamba2():
    """The same for Mamba2, whose slot carries an SSM state and a conv
    window."""
    _check_reused_slot_starts_clean("mamba2-130m")


@pytest.mark.parametrize("sampler", ["greedy", "temperature"])
def test_ragged_mamba2_prompt_on_the_kernel_route(sampler):
    """A 20-token prompt at the reduced chunk of 16: the port's "pallas"
    engine (the SSD kernel's route) gives the JAX "xla" engine's tokens;
    the JAX "pallas" engine refuses the prompt."""
    prompts = [list(range(3, 23)), [7, 1, 8] * 7 + [2, 8]]
    jax_eng = _jax_engine("mamba2-130m", "xla", "bulk", 2)
    want = _serve(jax_eng, JaxSampling(**SAMPLERS[sampler]), prompts)
    eng = _engine("mamba2-130m", "pallas", "bulk", 2)
    assert _serve(eng, SamplingParams(**SAMPLERS[sampler]), prompts) == want
    refusing = _jax_engine("mamba2-130m", "pallas", "bulk", 2)
    with pytest.raises(AssertionError):
        _serve(refusing, JaxSampling(), prompts[:1])


def test_gateway_surface():
    """The members the reference gateway duck-types behave like the JAX
    dense engine's on the same traffic."""
    arch = "qwen3-1.7b"
    engines = [_jax_engine(arch, "xla", "decode", 2),
               _engine(arch, "xla", "decode", 2)]
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
                eng.cache_metrics, sorted(eng.step_times), eng.ledger]
        eng.reset()
        row += [eng.has_work(), eng.free_token_capacity()]
        seen.append(row)
    assert seen[0] == seen[1]


def test_dense_layout_guards():
    """What the reference refuses on the dense layout, the port refuses
    with the same ValueError; a prompt longer than the cache is served
    (a ring keeps its last cache_len positions), as in the reference."""
    _, tcfg, _, tp = _model("qwen3-1.7b", "xla")
    base = dict(batch_slots=2, cache_len=CACHE_LEN, device="cpu")
    for kw, match in ((dict(decode_kernel="cuda"), "paged"),
                      (dict(fused_tokens=4), "paged"),
                      (dict(spec_tokens=2), "paged"),
                      (dict(scheduler="chunked"), "paged")):
        with pytest.raises(ValueError, match=match):
            ServeEngine(tp, tcfg, **base, **kw)
    eng = ServeEngine(tp, tcfg, **base)
    assert eng.decode_kernel == "reference"
    r = eng.submit(list(range(1, 41)), max_new_tokens=2)
    eng.run()
    assert r.done and len(r.output) == 2
