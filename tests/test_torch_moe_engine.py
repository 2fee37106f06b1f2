"""The port's paged ServeEngine on reduced granite-moe-1b-a400m (2 layers,
4 experts top-2, capacity factor 1.25) against the JAX ServeEngine with
the same keyword arguments, float32 on the CPU, the reference's own
weights bridged over: the single-token, fused, speculative and chunked
paths, in both prefill modes, greedy and seeded-sampled.

The MoE's capacity is per dispatch group, and the group differs by path:
a bucketed bulk prefill is one group of the padded bucket, a radix hit's
suffix prefill one group of the padded suffix, a decode step one group
per slot (never a drop: C >= K), and the chunked scheduler's mixed step
ONE group of all decode rows (idle slots included) and the padded chunk
rows, so a chunk's tokens can push a decode row's expert past capacity.
Those are the reference's semantics; the bar is token identity with the
JAX engine on each path, and the runs must include real drops in a bulk
prefill and in a mixed step (the port's `moe_ffn` is wrapped to record
them).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.sampler import SamplingParams as JaxSampling  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.sampler import SamplingParams  # noqa: E402
from _torch_parity import bridged_model  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

ARCH = "granite-moe-1b-a400m"
BS = 4
PATHS = {
    "single": dict(kv_layout="paged"),
    "fused": dict(kv_layout="paged", fused_tokens=4),
    "speculative": dict(kv_layout="paged", spec_tokens=3, drafter="ngram"),
    "chunked": dict(kv_layout="paged", scheduler="chunked", chunk_budget=3),
}
# a shared repetitive prefix (radix hits, n-gram acceptances), one prompt
# that matches a cached page only in part, and prompts long enough that a
# bucket holds more entries than an expert's slots
PROMPTS = [[3, 1, 4, 3, 1, 4, 3, 1, 5, 9, 2, 6], [3, 1, 4, 3, 7],
           [9, 10, 11, 12, 13, 14, 15, 16, 17], [5, 5, 5, 5, 5, 5],
           [3, 1, 4, 3, 1, 4, 3, 1, 9, 9, 2]]
SAMPLERS = {"greedy": {}, "temperature": dict(temperature=0.8, seed=11)}


@pytest.fixture(scope="module")
def model():
    return bridged_model(ARCH)


@pytest.fixture
def drops(monkeypatch):
    """(group length, dropped entries) of every port MoE call with a
    drop."""
    seen = []
    plain = TM.moe_ffn

    def recording(params, cfg, x, *, want_aux=False, **kw):
        out, aux = plain(params, cfg, x, want_aux=True, **kw)
        frac = float(aux["dropped_frac"])
        if frac > 0:
            seen.append((x.shape[1], frac))
        return out, (aux if want_aux else None)
    monkeypatch.setattr(TM, "moe_ffn", recording)
    return seen


def _kw(path, prefill_mode, slots=2):
    return dict(PATHS[path], batch_slots=slots, cache_len=32, block_size=BS,
                prefill_mode=prefill_mode)


def _serve(engine, sampling, prompts=PROMPTS):
    reqs = [engine.submit(p, max_new_tokens=3 + 2 * i, sampling=sampling)
            for i, p in enumerate(prompts)]
    engine.run()
    for r in reqs:
        assert r.done and r.error is None
    return [r.output for r in reqs]


_JAX_ENGINES = {}


def _jax_tokens(model, path, prefill_mode, sampler, slots=2,
                prompts=PROMPTS):
    key = (path, prefill_mode, slots)
    eng = _JAX_ENGINES.get(key)
    if eng is None:
        jcfg, _, jp, _ = model
        eng = _JAX_ENGINES[key] = JaxEngine(jp, jcfg,
                                            **_kw(path, prefill_mode, slots))
    else:
        eng.reset()
    return _serve(eng, JaxSampling(**SAMPLERS[sampler]), prompts)


def _port_engine(model, path, prefill_mode, slots=2):
    _, tcfg, _, tp = model
    return ServeEngine(tp, tcfg, **_kw(path, prefill_mode, slots),
                       device="cpu")


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
@pytest.mark.parametrize("prefill_mode", ["decode", "bulk"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_moe_engine_matches_jax_engine(model, drops, path, prefill_mode,
                                       sampler):
    eng = _port_engine(model, path, prefill_mode)
    got = _serve(eng, SamplingParams(**SAMPLERS[sampler]))
    assert got == _jax_tokens(model, path, prefill_mode, sampler)
    eng.manager.check_invariants()
    assert eng.cache_metrics.hits > 0          # suffix-only prefills ran
    if prefill_mode == "bulk" and path != "chunked":
        # a bucketed prompt overflowed an expert
        assert any(s >= 8 for s, _ in drops), drops
    if path == "chunked":
        # the mixed step's one group (2 decode rows + a 3-row chunk)
        assert any(s == 2 + 3 for s, _ in drops), drops


@pytest.mark.parametrize("path", ["single", "chunked"])
def test_idle_slots_join_the_mixed_group(model, drops, path):
    """Four slots, two requests: the idle slots' rows are in the chunked
    step's group (4 decode rows + 3 chunk rows) and in every decode
    batch, and the tokens are still the JAX engine's."""
    prompts = PROMPTS[:2]
    eng = _port_engine(model, path, "bulk", slots=4)
    got = _serve(eng, SamplingParams(), prompts)
    assert got == _jax_tokens(model, path, "bulk", "greedy", 4, prompts)
    if path == "chunked":
        assert any(s == 4 + 3 for s, _ in drops), drops


def test_mixed_group_makes_tokens_depend_on_the_slot_count(model):
    """A reference fault the port copies (ROADMAP Queue 3): the chunked
    step dispatches every decode row, idle slots included, and the chunk
    rows as one MoE group, so a request's tokens depend on how many slots
    the engine has. With one slot (1 + 3 rows, C = 2) request 1's token 7
    is 465; with two (2 + 3 rows, C = 3), and on the single-token path,
    it is 92. Both packages give both answers."""
    prompts = [PROMPTS[0], PROMPTS[1], PROMPTS[2]]
    jcfg, tcfg, jp, tp = model
    outs = {}
    for slots in (1, 2):
        kw = dict(PATHS["chunked"], batch_slots=slots, cache_len=64,
                  block_size=BS, prefill_mode="bulk")
        for name, eng in (("jax", JaxEngine(jp, jcfg, **kw)),
                          ("port", ServeEngine(tp, tcfg, **kw,
                                               device="cpu"))):
            reqs = [eng.submit(p, max_new_tokens=20) for p in prompts]
            eng.run()
            outs[name, slots] = [r.output for r in reqs]
    assert outs["port", 1] == outs["jax", 1]
    assert outs["port", 2] == outs["jax", 2]
    one, two = outs["jax", 1][1], outs["jax", 2][1]
    first = next(i for i, (a, b) in enumerate(zip(one, two)) if a != b)
    assert (first, one[first], two[first]) == (7, 465, 92)


def test_decode_never_drops(model):
    """A decode group is one token, so C = max(K, round(K * cf / E)) >=
    K: nothing is dropped at any capacity factor."""
    _, tcfg, _, tp = model
    lp = tp["layers"][0]["ffn"]
    x = torch.randn((6, 1, tcfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    for cf in (0.01, 1.25):
        cfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                   capacity_factor=cf))
        _, aux = TM.moe_ffn(lp, cfg, x, want_aux=True)
        assert float(aux["dropped_frac"]) == 0.0
    assert np.isfinite(TM.moe_ffn(lp, tcfg, x)[0].numpy()).all()
