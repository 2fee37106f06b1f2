"""The port's paged ServeEngine behavior, case for case the reference's
tests/test_paged_engine.py: prefix reuse accounting (shared blocks
prefilled exactly once), copy-on-write safety, eviction under pool
pressure, request-scoped failures, bulk-prefill bucketing, and the fused
and speculative lanes' mechanics (EOS, hooks, rollback bookkeeping, layout
guards). Where the reference's test compares outputs, the port's are also
held to the JAX engine's on the same weights (the reference's draw,
bridged): greedy tokens identical. Float32 on the CPU; the paged read is
the kernel's plain version there."""
import pytest

jax = pytest.importorskip("jax")

from _torch_host import one_torch_thread  # noqa: E402,F401
from _torch_tiny import (BS, V, jax_engine, outputs,  # noqa: E402
                         port_engine, tiny)
from repro_torch.configs.base import ModelConfig, SSMConfig  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.step import bucket_len  # noqa: E402

PROMPTS = [[3, 1, 4, 1, 5], [7, 8], [9, 10, 11, 12], [3, 1, 4, 2, 9]]


@pytest.fixture(scope="module")
def model():
    return tiny()


def _engine(model, kv="paged", mode="decode", jax_side=False, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("cache_len", 32)
    if kv == "paged":
        kw.setdefault("block_size", BS)
    make = jax_engine if jax_side else port_engine
    return make(model, prefill_mode=mode, kv_layout=kv, **kw)


@pytest.mark.parametrize("scan,tail", [(False, ()), (True, ("attn",)),
                                       (False, ("attn",))])
def test_paged_matches_dense_across_stacking(scan, tail):
    """Paged against dense for every layer-stacking shape (the port's
    layer loop has no scan: `scan_layers` changes nothing there, and the
    tail layers follow the blocks); the JAX dense engine agrees."""
    m = tiny(n_layers=3 if tail else 2, tail_pattern=tail, scan_layers=scan)
    outs = {}
    for kv in ("dense", "paged"):
        eng = _engine(m, kv=kv, mode="bulk")
        outs[kv] = outputs(eng, PROMPTS[:2], max_new=4)
    assert outs["paged"] == outs["dense"]
    ref = outputs(_engine(m, kv="dense", mode="bulk", jax_side=True),
                  PROMPTS[:2], max_new=4)
    assert outs["paged"] == ref


def test_shared_prefix_prefilled_exactly_once(model):
    prefix = [(i * 3 + 2) % V for i in range(8)]         # 2 full blocks
    prompts = [prefix + [20 + i, 30 + i] for i in range(4)]
    eng = _engine(model, batch_slots=1)                  # serialize admits
    outs = outputs(eng, prompts, max_new=3)
    m = eng.cache_metrics
    assert eng.prefill_tokens_computed == (8 + 2) + 3 * 2
    assert m.hits == 3 and m.misses == 1
    assert m.tokens_reused == 3 * 8
    assert outs == outputs(_engine(model, kv="dense", batch_slots=1),
                           prompts, max_new=3)
    ref = _engine(model, batch_slots=1, jax_side=True)
    assert outs == outputs(ref, prompts, max_new=3)
    assert ref.prefill_tokens_computed == eng.prefill_tokens_computed


def test_cow_does_not_corrupt_cached_chain(model):
    base = [(i * 5 + 1) % V for i in range(10)]
    fork = base[:9] + [17]                               # diverges in-block
    eng = _engine(model, batch_slots=1)
    out_base1 = outputs(eng, [base], max_new=4)[0]
    out_fork = outputs(eng, [fork], max_new=4)[0]
    assert eng.cache_metrics.cow_copies >= 1
    out_base2 = outputs(eng, [base], max_new=4)[0]       # original chain
    assert out_base2 == out_base1
    want = [out_base1, out_fork, out_base2]
    assert outputs(_engine(model, kv="dense", batch_slots=1),
                   [base, fork, base], max_new=4) == want
    assert outputs(_engine(model, kv="dense", batch_slots=1, jax_side=True),
                   [base, fork, base], max_new=4) == want


def test_eviction_under_pool_pressure_keeps_outputs(model):
    prompts = [[(i * 7 + j) % V for j in range(10 + i % 3)]
               for i in range(6)]
    eng = _engine(model, batch_slots=2, cache_len=24,
                  pool_blocks=2 * (24 // BS) + 2)
    paged = outputs(eng, prompts, max_new=4)
    assert eng.cache_metrics.blocks_evicted > 0
    eng.manager.check_invariants()
    assert paged == outputs(_engine(model, kv="dense", batch_slots=2,
                                    cache_len=24), prompts, max_new=4)
    ref = _engine(model, batch_slots=2, cache_len=24,
                  pool_blocks=2 * (24 // BS) + 2, jax_side=True)
    assert paged == outputs(ref, prompts, max_new=4)
    assert ref.cache_metrics.blocks_evicted == \
        eng.cache_metrics.blocks_evicted


def test_oversized_request_fails_request_scoped(model):
    eng = _engine(model, batch_slots=1, cache_len=32, pool_blocks=4)
    big = eng.submit(list(range(20)), max_new_tokens=4)
    ok = eng.submit([1, 2, 3], max_new_tokens=3)
    eng.run()
    assert big.error is not None and big.done
    assert ok.done and len(ok.output) == 3 and ok.error is None


def test_over_capacity_submit_rejected(model):
    eng = _engine(model, cache_len=16)
    with pytest.raises(ValueError):
        eng.submit(list(range(14)), max_new_tokens=8)    # 22 > 16


def test_paged_requires_pure_attention():
    cfg = ModelConfig("h", "hybrid", 2, 32, 2, 2, 64, V,
                      block_pattern=("ssm",),
                      ssm=SSMConfig(d_state=8, head_dim=16))
    import torch
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError):
        ServeEngine(params, cfg, kv_layout="paged", cache_len=32,
                    block_size=BS, device="cpu")


# ------------------------------------------------- decode kernel / fused

def _eos_case(model, **variant):
    probe = outputs(_engine(model), [PROMPTS[0]], max_new=8)[0]
    eos = probe[len(probe) // 2]
    out = {}
    for name, kw in (("single", {}), ("variant", variant)):
        eng = _engine(model, **kw)
        r = eng.submit(PROMPTS[0], max_new_tokens=8, eos_id=eos)
        eng.run()
        out[name] = r.output
    assert out["variant"] == out["single"] and len(out["single"]) < len(probe)
    ref = _engine(model, jax_side=True)
    r = ref.submit(PROMPTS[0], max_new_tokens=8, eos_id=eos)
    ref.run()
    assert r.output == out["single"]


def test_fused_decode_respects_eos(model):
    _eos_case(model, fused_tokens=8)


def _hooks_case(model, **variant):
    eng = _engine(model, **variant)
    seen = []
    eng.on_token = lambda req, tok: seen.append((req.request_id, tok))
    reqs = [eng.submit(p, max_new_tokens=5) for p in PROMPTS[:2]]
    eng.run()
    for r in reqs:
        assert [t for i, t in seen if i == r.request_id] == r.output


def test_fused_streams_tokens_through_hooks(model):
    _hooks_case(model, fused_tokens=4)


def test_fused_requires_paged_layout(model):
    _, _, params, cfg = model
    for kw in (dict(fused_tokens=4), dict(decode_kernel="cuda"),
               dict(spec_tokens=4)):
        with pytest.raises(ValueError):
            ServeEngine(params, cfg, kv_layout="dense", device="cpu", **kw)


# ---------------------------------------------------------- speculative

def test_spec_decode_respects_eos(model):
    _eos_case(model, spec_tokens=4)


def test_spec_streams_tokens_through_hooks(model):
    _hooks_case(model, spec_tokens=3)


def test_spec_rollback_bookkeeping(model):
    eng = _engine(model, spec_tokens=4)
    reqs = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
    eng.run()
    sm = eng.spec_metrics
    assert sm["dispatches"] == eng.spec_dispatches > 0
    assert sm["tokens_emitted"] == sum(len(r.output) - 1 for r in reqs)
    assert sm["tokens_rolled_back"] == \
        eng.manager.metrics.tokens_rolled_back > 0
    assert eng.manager.metrics.rollbacks > 0
    assert 0.0 <= sm["acceptance_rate"] <= 1.0
    eng.manager.check_invariants()


@pytest.mark.parametrize("prompt,max_new,rolls_back", [
    ([(i * 3 + 2) % V for i in range(8)], 4, False),    # the reference's
    ([(i * 5 + 1) % V for i in range(8)], 6, True),     # drafts rejected
], ids=["reference", "rolled-back"])
def test_spec_rollback_chain_stays_reusable(model, prompt, max_new,
                                            rolls_back):
    """After a speculative run retires (its rollbacks done before the
    commit), the same prompt again gets a correct radix hit: rolled-back
    rows never leak into the reusable prefix."""
    eng = _engine(model, batch_slots=1, spec_tokens=3)
    out1 = outputs(eng, [prompt], max_new=max_new)[0]
    assert (eng.manager.metrics.rollbacks > 0) == rolls_back
    out2 = outputs(eng, [prompt], max_new=max_new)[0]
    assert out2 == out1
    assert eng.cache_metrics.hits >= 1                   # prefix was reused
    eng.manager.check_invariants()
    assert outputs(_engine(model, kv="dense", batch_slots=1),
                   [prompt, prompt], max_new=max_new) == [out1, out2]
    assert outputs(_engine(model, batch_slots=1, spec_tokens=3,
                           jax_side=True), [prompt, prompt],
                   max_new=max_new) == [out1, out2]


def test_spec_takes_precedence_over_fused(model):
    plain = outputs(_engine(model), PROMPTS[:2], max_new=5)
    eng = _engine(model, spec_tokens=3, fused_tokens=4)
    assert outputs(eng, PROMPTS[:2], max_new=5) == plain
    assert eng.spec_dispatches > 0
    assert outputs(_engine(model, jax_side=True), PROMPTS[:2],
                   max_new=5) == plain


# ------------------------------------------------------------- bucketing

def test_bucket_len():
    assert [bucket_len(n, 64) for n in (1, 2, 3, 5, 8, 9, 33)] == \
        [1, 2, 4, 8, 8, 16, 64]
    assert bucket_len(80, 64) == 80              # never rounds down
    assert bucket_len(5, 0) == 8                 # uncapped


def test_bulk_prefill_buckets_bound_retraces(model):
    """Bulk prefill pads prompts to power-of-two buckets, so serving many
    natural lengths runs few prefill shapes (the reference counts jit
    traces; the port, having none, counts the distinct padded lengths its
    prefill is called with) — and the padding changes no output."""
    prompts = [[(i + j) % V for j in range(n)]
               for i, n in enumerate((3, 5, 6, 7))]
    eng = _engine(model, kv="dense", mode="bulk", batch_slots=2)
    shapes = set()
    prefill = eng._prefill_tok

    def counted(params, batch, n_tok):
        shapes.add(tuple(batch["tokens"].shape))
        return prefill(params, batch, n_tok)
    eng._prefill_tok = counted
    outs = outputs(eng, prompts, max_new=4)
    assert shapes == {(1, 4), (1, 8)}      # lengths 3,5,6,7 -> buckets 4, 8
    assert outs == outputs(_engine(model, kv="dense", mode="decode",
                                   batch_slots=2), prompts, max_new=4)
    assert outs == outputs(_engine(model, kv="dense", mode="bulk",
                                   batch_slots=2, jax_side=True),
                           prompts, max_new=4)
