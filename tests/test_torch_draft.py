"""The port's drafters (`repro_torch.serve.draft`): the reference's
tests/test_draft.py, case for case, plus the proposals themselves held
against the reference's drafters — the n-gram drafter on the same
contexts, the model drafter on reduced qwen3-1.7b with the reference's own
weights bridged over (float32, CPU). Proposals are greedy token ids, so
the bar is equality.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.serve import draft as JD  # noqa: E402
from repro_torch.serve.draft import (ModelDrafter, NGramDrafter,  # noqa: E402
                                     make_drafter)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from _torch_parity import bridged_model  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def model():
    return bridged_model("qwen3-1.7b")


def test_ngram_proposes_continuation_of_last_match():
    d = NGramDrafter(n=3)
    #            0  1  2  3  4  5  6  7
    ctx = [5, 6, 7, 9, 5, 6, 7, 8, 5, 6, 7]
    # trailing 3-gram (5,6,7) last occurred at index 4..6, followed by 8
    assert d.propose(ctx, 2) == [8, 5]
    # k beyond the known continuation pads by repeating the last proposal
    assert d.propose(ctx, 6) == [8, 5, 6, 7, 7, 7]


def test_ngram_prefers_longest_order_then_falls_back():
    d = NGramDrafter(n=3)
    assert d.propose([4, 2, 9, 4], 2) == [2, 9]
    assert d.propose([1, 2, 3], 3) == [3, 3, 3]
    assert d.propose([], 2) == [0, 0]
    with pytest.raises(ValueError):
        NGramDrafter(n=0)


def test_ngram_is_deterministic_and_matches_the_reference():
    d = NGramDrafter()
    ctx = [1, 2, 1, 2, 1]
    assert d.propose(ctx, 4) == d.propose(ctx, 4)
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 5):
        mine, ref = NGramDrafter(n), JD.NGramDrafter(n)
        for _ in range(40):
            ctx = rng.integers(0, 6, int(rng.integers(0, 30))).tolist()
            k = int(rng.integers(1, 7))
            assert mine.propose(ctx, k) == ref.propose(ctx, k)


def test_model_drafter_matches_target_greedy(model):
    """Drafting with the target's own weights reproduces the target's
    greedy continuation exactly, and an engine speculating with it accepts
    every draft."""
    _, tcfg, _, tp = model
    prompt = [3, 1, 4, 1, 5]
    eng = ServeEngine(tp, tcfg, batch_slots=1, cache_len=32, device="cpu")
    req = eng.submit(prompt, max_new_tokens=5)
    eng.run()
    d = ModelDrafter(tp, tcfg, cache_len=64)
    assert d.propose(prompt, 5) == req.output
    spec = ServeEngine(tp, tcfg, batch_slots=1, cache_len=32,
                       kv_layout="paged", block_size=4, spec_tokens=3,
                       drafter=ModelDrafter(tp, tcfg, cache_len=64),
                       device="cpu")
    sreq = spec.submit(prompt, max_new_tokens=5)
    spec.run()
    assert sreq.output == req.output
    assert spec.spec_metrics["acceptance_rate"] == 1.0


@pytest.mark.parametrize("incremental", [True, False])
def test_model_drafter_matches_the_reference_drafter(model, incremental):
    """Both drafters on the same weights and the same sequence of growing
    contexts (a speculation round's shape: the accepted drafts plus a
    bonus token, then a context that shares only a prefix): the same
    proposals and the same counts of draft-model work."""
    jcfg, tcfg, jp, tp = model
    mine = ModelDrafter(tp, tcfg, cache_len=64, incremental=incremental)
    ref = JD.ModelDrafter(jp, jcfg, cache_len=64, incremental=incremental)
    rng = np.random.default_rng(1)
    ctx = rng.integers(0, tcfg.vocab_size, 6).tolist()
    for step in range(6):
        got, want = mine.propose(ctx, 4), ref.propose(ctx, 4)
        assert got == want
        ctx = ctx + want[:2] + [int(rng.integers(0, tcfg.vocab_size))]
        if step == 3:
            ctx = ctx[:5] + rng.integers(0, tcfg.vocab_size, 3).tolist()
    for key in ("prefill_forwards", "decode_forwards", "tokens_fed"):
        assert getattr(mine, key) == getattr(ref, key)


def test_model_drafter_incremental_kv_matches_fresh(model):
    """The incremental draft cache changes only the work, never the
    proposals."""
    _, tcfg, _, tp = model
    prompts = [[3, 1, 4, 1, 5], [9, 8, 7]]

    def drive(drafter):
        eng = ServeEngine(tp, tcfg, batch_slots=2, cache_len=64,
                          kv_layout="paged", block_size=4, spec_tokens=3,
                          drafter=drafter, device="cpu")
        reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        eng.run()
        return [r.output for r in reqs]

    inc = ModelDrafter(tp, tcfg, cache_len=64)
    fresh = ModelDrafter(tp, tcfg, cache_len=64, incremental=False)
    assert drive(inc) == drive(fresh)
    assert inc.prefill_forwards < fresh.prefill_forwards
    assert inc.tokens_fed < fresh.tokens_fed
    before = inc.tokens_fed
    a = inc.propose(prompts[0], 4)
    b = inc.propose(prompts[0], 4)
    assert a == b
    assert inc.tokens_fed - before <= 2 * 4 + 2


def test_make_drafter_specs():
    assert make_drafter(None).name == "ngram:3"
    assert make_drafter("ngram").name == "ngram:3"
    assert make_drafter("ngram:5").n == 5
    inst = NGramDrafter(2)
    assert make_drafter(inst) is inst
    with pytest.raises(ValueError):
        make_drafter("markov")


def test_make_drafter_model_spec_uses_registry():
    """The port's registry and seeded `init_lm`, on the device asked for:
    the same seed gives the same proposals."""
    d = make_drafter("model:qwen3-1.7b", device="cpu")
    assert isinstance(d, ModelDrafter) and d.name == "model:qwen3-1.7b"
    assert d.cfg.d_model == 256 and d.device.type == "cpu"
    out = d.propose([1, 2, 3], 4)
    assert len(out) == 4
    again = make_drafter("model:qwen3-1.7b", device="cpu")
    assert again.propose([1, 2, 3], 4) == out
