"""The port's copy of tests/test_chaos_recovery.py, case for case:
repro_torch's tiny-config engines on the CPU (seeded torch weights,
`device="cpu"`). The reference's docstring follows.

Crash-recovery properties (satellite 3): journal reload with in-flight
work under seeded-random submit/dispatch/crash/reload interleavings.

Invariants, for every interleaving:

  * **at-least-once** — every task whose `put` record survives in the
    journal and was not acked before the crash is adopted and served by
    the next gateway process;
  * **attribution survives adoption** — tenant/tier ride the durable
    payload, so the adopted handle carries the original values;
  * **no orphaned leases** — leases are process-local; after reload and
    run the queue holds zero leases and zero pending work;
  * **pool conservation** — KV block refcounts stay consistent through
    mid-prefill teardown (crash-evict of a chunk-prefilling slot).

The seeded-random sweep always runs; when hypothesis is installed the
same scenario is additionally driven property-style over a wider seed
space (clean skip otherwise, via tests/_hyp)."""
import json
import os
import random
import tempfile

import pytest
import torch

from _hyp import HAVE_HYPOTHESIS, given, settings, st
from _torch_host import one_torch_thread, shut_down_gateways  # noqa: F401
from repro_torch.chaos import FaultInjector, parse_plan
from repro_torch.configs.base import ModelConfig
from repro_torch.core.queue import TaskQueue, TaskSpec
from repro_torch.gateway.gateway import Gateway
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

V = 41
_MODEL = None


def _model():
    """Module-cached tiny model (plain function, not a fixture, so the
    hypothesis-driven test can use it without fixture-scope warnings)."""
    global _MODEL
    if _MODEL is None:
        cfg = ModelConfig("t", "dense", 2, 32, 2, 2, 64, V)
        _MODEL = (T.init_lm(torch.Generator().manual_seed(0), cfg), cfg)
    return _MODEL


def _build(journal):
    params, cfg = _model()
    return Gateway.build(params, cfg, device="cpu", replicas=1, batch_slots=2,
                         cache_len=32, kv_layout="paged", block_size=4,
                         scheduler="chunked", chunk_budget=3,
                         journal_path=journal)


def _journal_state(path):
    """Parse a (possibly torn) journal: surviving put/ack/dead ids."""
    puts, acked, dead = {}, set(), set()
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            assert i == len(lines) - 1, "tore a non-final record"
            break
        if rec["op"] == "put":
            spec = TaskSpec.from_json(rec["task"])
            puts[spec.task_id] = spec
        elif rec["op"] == "ack":
            acked.add(rec["id"])
        elif rec["op"] == "dead":
            dead.add(rec["id"])
    return puts, acked, dead


def _crash_reload_scenario(seed: int, tmpdir: str):
    """One seeded interleaving: submit, partially serve, crash (optionally
    tearing the journal tail), reload, run to completion, check all four
    invariants."""
    rng = random.Random(seed)
    journal = os.path.join(tmpdir, f"chaos-{seed}.journal")

    gw1 = _build(journal)
    meta = {}                   # task_id -> (tenant, tier)
    for i in range(rng.randint(1, 4)):
        tier = rng.randint(0, 2)
        r = gw1.submit([rng.randrange(1, V)
                        for _ in range(rng.randint(2, 14))],
                       max_new_tokens=rng.randint(1, 4),
                       tenant=f"tenant{i % 2}", tier=tier)
        meta[r.task_id] = (r.tenant, r.tier)
    # a random number of steps: depending on the draw the crash lands
    # before dispatch, mid-chunked-prefill, mid-decode, or after finish
    for _ in range(rng.randint(0, 6)):
        gw1.step()
    gw1.queue.close()           # process dies here; leases die with it
    if rng.random() < 0.5:      # mid-write crash: torn final record
        with open(journal) as f:
            n = len(f.readlines())
        FaultInjector.truncate_journal(
            journal, keep_frac=(n - 1) / n, torn_bytes=rng.randint(1, 30))

    puts, acked, dead = _journal_state(journal)
    owed = set(puts) - acked - dead

    gw2 = _build(journal)
    gw2.run()
    adopted = {h.task_id: h for h in gw2.requests()}
    # at-least-once: everything owed was adopted and served
    assert set(adopted) == owed
    for tid, h in adopted.items():
        assert h.done and len(h.output) == puts[tid].payload["max_new_tokens"]
        assert (h.tenant, h.tier) == meta[tid]   # attribution survived
    # no orphaned leases, nothing left pending
    stats = gw2.queue.stats()
    assert stats["leased"] == 0 and stats["pending"] == 0
    # pool conservation on the serving engine
    eng = gw2.replicas[0].engine
    eng.manager.pool.check_invariants()
    gw2.queue.close()


SEEDS = [3, 11, 42, 77, 1234]


@pytest.mark.parametrize("seed", SEEDS)
def test_crash_reload_interleavings_seeded(seed, tmp_path):
    _crash_reload_scenario(seed, str(tmp_path))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**20))
def test_crash_reload_interleavings_hypothesis(seed):
    with tempfile.TemporaryDirectory() as d:
        _crash_reload_scenario(seed, d)


# --------------------------------------------------- journal torn tail

def test_torn_tail_is_recovered_midline_corruption_refused(tmp_path):
    journal = os.path.join(tmp_path, "t.journal")
    q = TaskQueue(journal)
    specs = [TaskSpec.make("s", "op", {"i": i}) for i in range(5)]
    for s in specs:
        q.put(s)
    got = q.get()
    q.ack(got.task_id)
    q.close()

    with open(journal) as f:
        n = len(f.readlines())
    # tear the final record (the ack): every intact record is recovered
    FaultInjector.truncate_journal(journal, keep_frac=(n - 1) / n,
                                   torn_bytes=9)
    q2 = TaskQueue(journal)
    assert q2.stats()["pending"] == 5          # torn ack not applied
    assert q2.stats()["leased"] == 0
    q2.close()

    # corruption ANYWHERE ELSE is refused, not guessed around
    with open(journal) as f:
        lines = f.readlines()
    lines[1] = lines[1][:7] + "\n"
    with open(journal, "w") as f:
        f.writelines(lines)
    with pytest.raises(json.JSONDecodeError):
        TaskQueue(journal)


# ------------------------------------------- mid-prefill teardown

def test_mid_prefill_crash_eviction_conserves_pool():
    """A replica crash while a long prompt is mid-chunked-prefill must
    tear the victim down cleanly: slot chains decref'd, refcounts
    consistent, and the retry on the survivor reproduces the oracle."""
    params, cfg = _model()
    long_prompt = list(range(1, 17))             # 6 chunks at budget 3
    solo_eng = ServeEngine(params, cfg, device="cpu",
                           batch_slots=1, cache_len=32,
                           kv_layout="paged", block_size=4,
                           scheduler="chunked", chunk_budget=3)
    oracle = solo_eng.submit(long_prompt, max_new_tokens=4)
    solo_eng.run()

    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=32,
                       kv_layout="paged", block_size=4,
                       scheduler="chunked", chunk_budget=3,
                       policy="round-robin")
    inj = FaultInjector(parse_plan("crash@d2:r0")).arm(gw)
    r = gw.submit(long_prompt, max_new_tokens=4)
    gw.run()
    inj.disarm()
    assert inj.count("crash") == 1
    assert r.done and r.output == oracle.output
    dead_eng = gw.replicas[0].engine
    assert sum(len(b) for b in dead_eng._slot_blocks) == 0
    dead_eng.manager.pool.check_invariants()
    assert not gw.replicas[0].healthy            # no probation configured
    gw.replicas[1].engine.manager.pool.check_invariants()


def test_reset_after_mid_prefill_crash_restores_full_pool():
    params, cfg = _model()
    eng = ServeEngine(params, cfg, device="cpu", batch_slots=2, cache_len=32,
                      kv_layout="paged", block_size=4,
                      scheduler="chunked", chunk_budget=3)
    req = eng.submit(list(range(1, 17)), max_new_tokens=4)
    eng.step()                                   # first chunk only
    assert eng.manager.pool.allocated_count() > 0
    eng.evict(req)                               # mid-prefill teardown
    eng.manager.pool.check_invariants()
    eng.reset()
    pool = eng.manager.pool
    assert pool.free_count() == pool.n_blocks - 1
    pool.check_invariants()
