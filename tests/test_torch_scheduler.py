"""The port's chunked-prefill scheduler: the reference's
tests/test_scheduler.py, case for case, on `repro_torch` (the scheduler is
the reference's host-only code; the engine's mixed step is the port's).

The model is the reference test's tiny config (2 layers, d 32, 2/2 heads,
vocab 41) with the port's seeded `init_lm` weights; the oracle is the
port's own phased engine on the dense layout, as the reference's is its
own. Parity with the JAX engine is tests/test_torch_decode_variants.py's
job. The reference's last case drives the gateway, which is not ported
yet: its engine-level half (outputs, scheduler counters, per-kind step
times and ledger shares) is kept.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ChunkedScheduler
from repro_torch.serve.step import build_mixed_step

V = 41
BS = 4


@pytest.fixture(scope="module")
def model():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = ModelConfig("t", "dense", 2, 32, 2, 2, 64, V)
    yield T.init_lm(torch.Generator().manual_seed(0), cfg), cfg
    torch.set_num_threads(n)


def _engine(model, *, chunk_budget=3, slots=2, cache_len=32, **kw):
    params, cfg = model
    return ServeEngine(params, cfg, batch_slots=slots, cache_len=cache_len,
                       kv_layout="paged", block_size=BS,
                       scheduler="chunked", chunk_budget=chunk_budget,
                       device="cpu", **kw)


def _phased_outputs(model, prompts, max_new=6, cache_len=32, slots=2):
    params, cfg = model
    eng = ServeEngine(params, cfg, batch_slots=slots, cache_len=cache_len,
                      device="cpu")
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    return [r.output for r in reqs]


# ------------------------------------------------------------------ guards

def test_chunked_requires_paged_layout(model):
    params, cfg = model
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(params, cfg, scheduler="chunked", device="cpu")
    with pytest.raises(ValueError, match="scheduler"):
        ServeEngine(params, cfg, scheduler="dynamic", device="cpu")
    with pytest.raises(ValueError, match="chunk_budget"):
        ChunkedScheduler(0)


# ------------------------------------------------------- boundary geometry

@pytest.mark.parametrize("prompt_len,chunk", [
    (8, BS),        # every chunk boundary == a block boundary
    (8, 8),         # one chunk exactly covers the prompt
    (5, 8),         # chunk larger than the whole prompt
    (7, 3),         # final chunk shorter than the budget, off-block
    (9, 1),         # token-at-a-time degenerate budget
])
def test_chunk_boundary_geometry(model, prompt_len, chunk):
    prompt = [(3 * i + 1) % V for i in range(prompt_len)]
    want = _phased_outputs(model, [prompt])
    eng = _engine(model, chunk_budget=chunk)
    req = eng.submit(prompt, max_new_tokens=6)
    eng.run()
    assert req.output == want[0]
    m = eng.scheduler.metrics()
    assert m["prefill_tokens_chunked"] == prompt_len
    assert m["chunks_dispatched"] == -(-prompt_len // chunk)
    assert m["prefills_completed"] == 1 and m["prefills_in_flight"] == 0
    eng.manager.check_invariants()


def test_empty_prompt_chunked(model):
    want = _phased_outputs(model, [[]])
    eng = _engine(model)
    req = eng.submit([], max_new_tokens=6)
    eng.run()
    assert req.output == want[0]
    assert eng.scheduler.metrics()["chunks_dispatched"] == 0


def test_pure_prefill_no_decoders(model):
    """A one-slot engine has no decoding peers while the prompt chunks
    through: the mixed step still makes progress alone."""
    prompt = [(2 * i + 1) % V for i in range(11)]
    want = _phased_outputs(model, [prompt], slots=1)
    eng = _engine(model, chunk_budget=4, slots=1)
    req = eng.submit(prompt, max_new_tokens=6)
    eng.run()
    assert req.output == want[0]


# ----------------------------------------------------- in-flight admission

def test_admission_during_inflight_chunked_prefill(model):
    long_p = [(5 * i + 2) % V for i in range(12)]
    short_p = [9, 10, 11]
    want = _phased_outputs(model, [long_p, short_p])
    eng = _engine(model, chunk_budget=3)
    a = eng.submit(long_p, max_new_tokens=6)
    eng.step()                                  # long admitted, mid-prefill
    assert eng.scheduler.has_prefill_work()
    b = eng.submit(short_p, max_new_tokens=6)
    eng.run()
    assert [a.output, b.output] == want
    assert eng.scheduler.metrics()["prefills_started"] == 2
    eng.manager.check_invariants()


def test_chunk_boundary_commit_enables_midflight_reuse(model):
    """Pages committed at chunk boundaries are reused by a same-prefix
    request admitted while the first is still prefilling."""
    prefix = [7, 3, 7, 1] * 5                   # 20 tokens = 5 full pages
    eng = _engine(model, chunk_budget=4, slots=2, cache_len=64)
    a = eng.submit(prefix + [9], max_new_tokens=4)
    for _ in range(3):                          # 3 chunks committed so far
        eng.step()
    assert eng.scheduler.has_prefill_work()
    assert eng.cached_prefix_tokens(prefix) >= 8
    b = eng.submit(prefix + [11], max_new_tokens=4)
    eng.run()
    assert a.error is None and b.error is None
    assert eng.manager.metrics.tokens_reused > 0
    want = _phased_outputs(model, [prefix + [9], prefix + [11]],
                           max_new=4, cache_len=64)
    assert [a.output, b.output] == want
    eng.manager.check_invariants()


# ------------------------------------------------------ stall-free streams

def test_decoders_stream_during_long_prefill(model):
    """While a long prompt chunks through, a decoding request emits a
    token on every step; the long one's first token waits for its last
    chunk."""
    eng = _engine(model, chunk_budget=2, slots=2, cache_len=64)
    short = eng.submit([1, 2, 3], max_new_tokens=30)
    eng.step()                  # chunk 1 of 2: short itself mid-prefill
    eng.step()                  # chunk 2: short's deferred first token
    assert len(short.output) == 1
    emitted_during = []
    eng.on_token = lambda req, tok: emitted_during.append(req.request_id)
    long_req = eng.submit([(3 * i + 2) % V for i in range(16)],
                          max_new_tokens=4)
    for _ in range(8):                          # 16 tokens / chunk 2
        eng.step()
    eng.on_token = None
    assert emitted_during.count(short.request_id) == 8
    assert emitted_during.count(long_req.request_id) == 1
    assert emitted_during[-1] == long_req.request_id
    eng.run()


# ----------------------------------------------------------- eviction edge

def test_evict_half_prefilled_request_leaks_nothing(model):
    eng = _engine(model, chunk_budget=4, slots=2, cache_len=64)
    req = eng.submit([(3 * i + 1) % V for i in range(20)], max_new_tokens=4)
    eng.step()
    eng.step()
    assert eng.scheduler.has_prefill_work()
    assert eng.evict(req)
    assert not eng.scheduler.has_prefill_work()
    eng.manager.check_invariants()
    held = eng.manager.pool.allocated_count()
    tree = len(set(eng.manager.radix.all_blocks()))
    assert held == tree, "evicted half-prefilled request leaked blocks"
    eng.manager.radix.evict(10 ** 9)
    assert eng.manager.pool.allocated_count() == 0
    nxt = eng.submit([5, 6, 7], max_new_tokens=4)
    eng.run()
    assert nxt.done and nxt.error is None


# --------------------------------------------------- mixed step vs oracle

def test_mixed_step_matches_chunk_prefill_oracle(model):
    """The mixed step (one combined pool write per layer) writes the same
    K/V and gives the same chunk tokens as the chunk-only oracle
    `transformer.prefill_chunk_paged`."""
    params, cfg = model
    nb, slots, C = 8, 2, 4
    pool_blocks = 2 * slots * nb + 1
    tokens = [3, 1, 4, 1, 5, 9, 2, 6]
    chain = torch.arange(1, nb + 1, dtype=torch.int32)
    mixed = build_mixed_step(cfg)

    def run_chunks(fused):
        cache = T.init_paged_cache(cfg, pool_blocks, BS, device="cpu")
        outs = []
        for start in range(0, len(tokens), C):
            n = min(C, len(tokens) - start)
            ctoks = torch.tensor([tokens[start:start + n] + [0] * (C - n)],
                                 dtype=torch.int32)
            if fused:
                _, last, cache = mixed(
                    params, torch.zeros((slots, 1), dtype=torch.int32),
                    torch.zeros((slots,), dtype=torch.int32), cache,
                    torch.zeros((slots, nb), dtype=torch.int32), ctoks,
                    start, n, chain)
                outs.append(int(last))
            else:
                logits, cache = T.prefill_chunk_paged(params, cfg, ctoks,
                                                      start, n, cache, chain)
                outs.append(int(torch.argmax(logits[0, n - 1])))
        return outs, cache

    outs_f, cache_f = run_chunks(True)
    outs_o, cache_o = run_chunks(False)
    assert outs_f == outs_o
    for lf, lo in zip(cache_f, cache_o):
        for key in ("k", "v"):
            # pool row 0 is the null page: the masked decode rows and the
            # oracle's pad rows both dump different junk there
            np.testing.assert_allclose(lf[key][1:].numpy(),
                                       lo[key][1:].numpy(),
                                       rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ engine wire

def test_chunked_engine_end_to_end(model):
    """Several prompts through a two-slot chunked engine: the phased
    outputs, the scheduler counters, and a `mixed` step kind whose ledger
    shares give each decoding slot one token and the chunk its length."""
    prompts = [[(5 * i + j) % V for j in range(3 + 4 * i)] for i in range(4)]
    want = _phased_outputs(model, prompts, max_new=5, cache_len=64)

    class Ledger:
        def __init__(self):
            self.steps = []

        def record_step(self, kind, dt, shares, pool_blocks=0):
            self.steps.append((kind, dt, list(shares), pool_blocks))

    eng = _engine(model, chunk_budget=3, cache_len=64)
    eng.ledger = Ledger()
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    assert [r.output for r in reqs] == want
    sched = eng.scheduler_metrics
    assert sched["scheduler"] == "chunked" and sched["chunk_budget"] == 3
    assert sched["prefills_completed"] == len(prompts)
    assert sched["prefill_tokens_chunked"] == sum(len(p) for p in prompts)
    assert sched["mixed_dispatches"] == sched["chunks_dispatched"]
    summary = eng.step_summary()
    assert summary["mixed"]["count"] == sched["mixed_dispatches"]
    mixed = [s for s in eng.ledger.steps if s[0] == "mixed"]
    assert len(mixed) == sched["mixed_dispatches"]
    chunked = sum(s[2][-1][1] for s in mixed)
    assert chunked == sched["prefill_tokens_chunked"]
    assert all(t == 1 for s in mixed for _, t, _ in s[2][:-1])
    assert all(s[3] > 0 for s in mixed)
