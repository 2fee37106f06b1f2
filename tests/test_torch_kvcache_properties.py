"""Stateful property tests of the port's paged KV-cache bookkeeping
(repro_torch.kvcache: BlockPool, RadixTree, KVCacheManager), case for case
the reference's tests/test_kvcache_properties.py, and held against the
reference's copy (repro.kvcache).

`ManagerModel` is the reference test's model, with the manager's package
as a parameter: it drives the full lifecycle — admit (phased or chunked) /
chunk_prefill / generate / commit / release / evict / rollback / drain —
and after every operation asserts the invariants the manager docstring
promises (refcount conservation, no double free, `free_tokens`
exactness, rollback never touching a radix-shared page, chunked prefill
leaking nothing when released half-done).

Driven three ways:
  * the reference's seeded random walk, on the port's manager;
  * the reference's hypothesis RuleBasedStateMachine, on a port model and
    a reference model side by side, which must agree after every rule
    (derandomized, so the draws are the same in every run);
  * a differential walk: one seed drives both packages' models, and every
    Admission, eviction count, `metrics.as_dict()`, the pool's free list
    and refcounts, and `radix.all_blocks()` must be equal after every
    operation. It extends tests/test_torch_kvcache.py's walk (admit,
    commit, release, rollback) with the chunked admission and its chunk
    prefills, generate, radix eviction and drain.
"""
import random

import pytest

pytest.importorskip("jax")

from _hyp import HAVE_HYPOTHESIS  # noqa: E402
from repro import kvcache as jkv  # noqa: E402
from repro_torch import kvcache as tkv  # noqa: E402

BS = 4
POOL = 17


class _Req:
    __slots__ = ("blocks", "tokens", "committed", "floor", "cap", "prompt")

    def __init__(self, blocks, tokens, n_shared_tokens, prompt=None):
        self.blocks = blocks
        self.tokens = tokens            # prompt + generated, written so far
        self.committed = 0              # tokens indexed in the radix tree
        # rollback floor: shared prefix pages belong to other chains
        self.floor = n_shared_tokens
        self.cap = len(blocks) * BS     # chain token capacity
        # full target prompt; chunked-prefill admits write toward it in
        # bounded chunks (tokens starts at just the reused prefix)
        self.prompt = prompt if prompt is not None else list(tokens)


class ManagerModel:
    """Single source of truth for the hypothesis rules and both walks:
    every op goes through here, every op ends in check(). `kv` is the
    package whose KVCacheManager is under test. `last` is what the last
    op returned (an Admission, a refusal, an eviction count)."""

    def __init__(self, kv=tkv, n_blocks=POOL, bs=BS):
        self.kv = kv
        self.m = kv.KVCacheManager(n_blocks, bs)
        self.held = []
        self.last = None

    # ---------------------------------------------------------------- ops
    def admit(self, fam: int, ln: int, extra: int, chunked: bool = False):
        """Admit a request. `chunked` models the chunked-prefill
        scheduler: only the reused prefix counts as written on admission
        and `chunk_prefill` advances the rest in bounded chunks (the
        phased path writes the whole prompt here)."""
        prompt = [fam * 1000 + i for i in range(ln)]
        try:
            adm = self.m.admit(prompt, ln + extra)
        except self.kv.PoolExhausted as err:
            self.last = ("refused", str(err))
            self.check()
            return None
        self.last = ("admitted", adm.blocks, adm.n_reused, adm.cow,
                     adm.fresh)
        if adm.cow is not None:
            self.m.cow_done(adm.cow[0])
        shared = len(adm.blocks) - len(adm.fresh)
        written = list(prompt[:adm.n_reused]) if chunked else list(prompt)
        req = _Req(adm.blocks, written, shared * BS, prompt=prompt)
        self.held.append(req)
        self.check()
        return req

    def admit_chunked(self, fam: int, ln: int, extra: int):
        return self.admit(fam, ln, extra, chunked=True)

    def admit_phased(self, fam: int, ln: int, extra: int):
        return self.admit(fam, ln, extra, chunked=False)

    def chunk_prefill(self, idx: int, n: int):
        """One scheduler chunk: write up to `n` further prompt tokens,
        then radix-commit at the chunk boundary (full pages only) — the
        engine's `_step_mixed` contract. Past the prompt this degrades to
        a commit of whatever has been written (the retire-time shape)."""
        req = self.held[idx % len(self.held)]
        n = min(n, len(req.prompt) - len(req.tokens))
        if n > 0:
            req.tokens += req.prompt[len(req.tokens):len(req.tokens) + n]
        self.m.commit(req.tokens, req.blocks)
        n_full = min(len(req.tokens) // BS, len(req.blocks))
        req.committed = n_full * BS
        req.floor = max(req.floor, req.committed)
        self.last = len(req.tokens)
        self.check()

    def generate(self, idx: int, n: int):
        req = self.held[idx % len(self.held)]
        n = min(n, req.cap - len(req.tokens))
        base = 9_000 + len(req.tokens)
        req.tokens += [base + i for i in range(n)]
        self.last = len(req.tokens)
        self.check()

    def commit(self, idx: int):
        req = self.held[idx % len(self.held)]
        self.m.commit(req.tokens, req.blocks)
        n_full = min(len(req.tokens) // BS, len(req.blocks))
        req.committed = n_full * BS
        req.floor = max(req.floor, req.committed)
        self.last = req.committed
        self.check()

    def release(self, idx: int):
        req = self.held.pop(idx % len(self.held))
        self.m.release(req.blocks)
        self.last = req.blocks
        self.check()

    def evict(self, n: int):
        self.last = self.m.radix.evict(n)
        self.check()

    def rollback(self, idx: int, n_valid: int):
        """Reject speculative tokens: trim the tail of what a request has
        written back to n_valid (clamped to the engine-contract floor)."""
        req = self.held[idx % len(self.held)]
        n_valid = max(req.floor, min(n_valid, len(req.tokens)))
        self.last = self.m.rollback(req.blocks, n_valid, len(req.tokens))
        req.tokens = req.tokens[:n_valid]
        self.check()

    def drain(self):
        """free_tokens must be exactly achievable: evicting everything
        reclaims precisely what evictable_blocks predicted."""
        predicted = self.m.radix.evictable_blocks()
        freed = self.m.radix.evict(10 ** 9)
        assert freed == predicted, (
            f"evictable_blocks predicted {predicted}, evict freed {freed}")
        self.last = freed
        self.check()

    # ---------------------------------------------------------- invariant
    def check(self):
        self.m.check_invariants()
        tree = set(self.m.radix.all_blocks())
        counts = {}
        for req in self.held:
            for b in req.blocks:
                counts[b] = counts.get(b, 0) + 1
        for b in range(1, self.m.pool.n_blocks):
            expect = counts.get(b, 0) + (1 if b in tree else 0)
            assert self.m.pool.ref(b) == expect, (
                f"block {b}: ref={self.m.pool.ref(b)}, "
                f"held={counts.get(b, 0)}, in_tree={b in tree}")
        assert self.m.free_tokens() == (
            self.m.pool.free_count()
            + self.m.radix.evictable_blocks()) * BS

    def finish(self):
        while self.held:
            self.release(0)
        self.drain()
        assert self.m.pool.allocated_count() == 0

    # --------------------------------------------------------- comparison
    def snapshot(self):
        """Everything the differential tests compare after an op."""
        m = self.m
        return (self.last, m.metrics.as_dict(), list(m.pool._free),
                list(m.pool._ref), list(m.radix.all_blocks()),
                [(r.blocks, r.tokens, r.floor) for r in self.held])


class _Pair:
    """A port model and a reference model driven alike: each op is applied
    to both, then their snapshots must be equal."""

    def __init__(self):
        self.port = ManagerModel(tkv)
        self.ref = ManagerModel(jkv)
        self.log = []

    @property
    def held(self):
        return self.port.held

    def __getattr__(self, op):
        if op.startswith("_"):
            raise AttributeError(op)

        def both(*args, **kw):
            getattr(self.ref, op)(*args, **kw)
            getattr(self.port, op)(*args, **kw)
            snap = self.ref.snapshot()
            assert self.port.snapshot() == snap, (op, args, kw)
            self.log.append((op, snap))
        return both


# ------------------------------------------------------- seeded fallback

@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8))
def test_manager_random_walk_conserves_invariants(seed):
    """Seeded random interleaving of the full op set — runs everywhere,
    including environments without hypothesis."""
    rng = random.Random(seed)
    model = ManagerModel()
    for _ in range(120):
        op = rng.randrange(100)
        if op < 30 or not model.held:
            model.admit(rng.randrange(4), rng.randrange(1, 15),
                        rng.randrange(0, 10), chunked=rng.random() < 0.5)
        elif op < 45:
            model.chunk_prefill(rng.randrange(8), rng.randrange(1, 9))
        elif op < 55:
            model.generate(rng.randrange(8), rng.randrange(1, 12))
        elif op < 65:
            model.commit(rng.randrange(8))
        elif op < 78:
            model.rollback(rng.randrange(8), rng.randrange(0, 60))
        elif op < 88:
            model.release(rng.randrange(8))
        elif op < 95:
            model.evict(rng.randrange(1, 6))
        else:
            model.drain()
    model.finish()


# ------------------------------------------------- differential: the walk

def _differential_walk(seed, n_ops=300):
    """The random walk's op mix on a port/reference pair, admissions
    chunked or phased, under pool pressure (prompts of up to 14 tokens
    with up to 9 more reserved, in a pool of 16 usable blocks)."""
    rng = random.Random(seed)
    pair = _Pair()
    for _ in range(n_ops):
        op = rng.randrange(100)
        if op < 30 or not pair.held:
            chunked = rng.random() < 0.5
            getattr(pair, "admit_chunked" if chunked else "admit_phased")(
                rng.randrange(4), rng.randrange(1, 15), rng.randrange(0, 10))
        elif op < 45:
            pair.chunk_prefill(rng.randrange(8), rng.randrange(1, 9))
        elif op < 55:
            pair.generate(rng.randrange(8), rng.randrange(1, 12))
        elif op < 65:
            pair.commit(rng.randrange(8))
        elif op < 78:
            pair.rollback(rng.randrange(8), rng.randrange(0, 60))
        elif op < 88:
            pair.release(rng.randrange(8))
        elif op < 95:
            pair.evict(rng.randrange(1, 6))
        else:
            pair.drain()
    pair.finish()
    return pair.log


@pytest.mark.parametrize("seed", range(4))
def test_manager_walk_matches_reference(seed):
    log = _differential_walk(seed)
    kinds = {op for op, _ in log}
    assert {"admit_chunked", "admit_phased", "chunk_prefill", "generate",
            "commit", "rollback", "release", "evict", "drain"} <= kinds
    # the pool ran out at least once, evicted, and copied a part page
    assert any(op.startswith("admit") and snap[0][0] == "refused"
               for op, snap in log)
    assert any(op == "evict" and snap[0] > 0 for op, snap in log)
    counters = log[-1][1][1]
    assert counters["blocks_evicted"] > 0 and counters["cow_copies"] > 0
    assert counters["rollbacks"] > 0


# --------------------------------------------------- hypothesis stateful

if HAVE_HYPOTHESIS:
    from hypothesis import settings
    from hypothesis import strategies as st
    from hypothesis.stateful import (RuleBasedStateMachine, precondition,
                                     rule)

    class ManagerMachine(RuleBasedStateMachine):
        def __init__(self):
            super().__init__()
            self.model = _Pair()

        @rule(fam=st.integers(0, 3), ln=st.integers(1, 14),
              extra=st.integers(0, 9), chunked=st.booleans())
        def admit(self, fam, ln, extra, chunked):
            self.model.admit(fam, ln, extra, chunked=chunked)

        @precondition(lambda self: self.model.held)
        @rule(idx=st.integers(0, 7), n=st.integers(1, 8))
        def chunk_prefill(self, idx, n):
            self.model.chunk_prefill(idx, n)

        @precondition(lambda self: self.model.held)
        @rule(idx=st.integers(0, 7), n=st.integers(1, 11))
        def generate(self, idx, n):
            self.model.generate(idx, n)

        @precondition(lambda self: self.model.held)
        @rule(idx=st.integers(0, 7))
        def commit(self, idx):
            self.model.commit(idx)

        @precondition(lambda self: self.model.held)
        @rule(idx=st.integers(0, 7), n_valid=st.integers(0, 59))
        def rollback(self, idx, n_valid):
            self.model.rollback(idx, n_valid)

        @precondition(lambda self: self.model.held)
        @rule(idx=st.integers(0, 7))
        def release(self, idx):
            self.model.release(idx)

        @rule(n=st.integers(1, 5))
        def evict(self, n):
            self.model.evict(n)

        @rule()
        def drain(self):
            self.model.drain()

        def teardown(self):
            self.model.finish()

    ManagerMachine.TestCase.settings = settings(
        max_examples=60, stateful_step_count=40, deadline=None,
        derandomize=True)
    TestManagerStateful = pytest.mark.slow(ManagerMachine.TestCase)
else:  # pragma: no cover - exercised only without hypothesis
    @pytest.mark.slow
    def test_manager_stateful_requires_hypothesis():
        pytest.skip("hypothesis not installed; seeded fallback ran instead")
