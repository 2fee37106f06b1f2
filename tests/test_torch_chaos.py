"""The port's copy of tests/test_chaos.py, case for case:
repro_torch's tiny-config engines on the CPU (seeded torch weights,
`device="cpu"`). The reference's docstring follows.

Chaos subsystem: deterministic fault plans, the injection seams, replica
lifecycle recovery (probation, poison quarantine), graceful brownout, and
output fidelity under every fault kind across all decode paths."""
import time

import pytest
import torch

from _torch_host import one_torch_thread, shut_down_gateways  # noqa: F401
from repro_torch.chaos import FaultInjector, FaultPlan, FaultSpec, parse_plan
from repro_torch.chaos.faults import resolve_targets
from repro_torch.configs.base import ModelConfig
from repro_torch.gateway.gateway import BrownoutConfig, Gateway
from repro_torch.models import transformer as T
from repro_torch.obs.slo import SLOTracker
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sampler import SamplingParams

V = 41
PROMPTS = [[3, 1, 4, 1], [5, 9, 2], [6, 5, 3, 5], [8, 9, 7]]

PATHS = {
    "dense": dict(kv_layout="dense"),
    "paged_ref": dict(kv_layout="paged", decode_kernel="reference"),
    "paged_cuda": dict(kv_layout="paged", decode_kernel="cuda"),
    "fused": dict(kv_layout="paged", fused_tokens=4),
    "speculative": dict(kv_layout="paged", spec_tokens=3, drafter="ngram"),
    "chunked": dict(kv_layout="paged", scheduler="chunked", chunk_budget=3),
}


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig("t", "dense", 2, 32, 2, 2, 64, V)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    return params, cfg


@pytest.fixture(scope="module")
def oracle(model):
    """Fault-free greedy outputs, one isolated dense engine per prompt."""
    params, cfg = model
    outs = []
    for p in PROMPTS:
        eng = ServeEngine(params, cfg, device="cpu",
                          batch_slots=1, cache_len=64)
        r = eng.submit(p, max_new_tokens=4)
        eng.run()
        outs.append(r.output)
    return outs


# ------------------------------------------------------------- fault plans

def test_plan_dsl_parses_every_kind():
    plan = parse_plan(
        "crash@d6:r0,slow@d4-12:r1:2ms,pool@s8-40:r0:4,nan@d3:r0,expire@s10",
        seed=3)
    assert [f.kind for f in plan.faults] == [
        "crash", "straggler", "pool_pressure", "nan_logits", "lease_expiry"]
    crash, slow, pool, nan, expire = plan.faults
    assert crash.at_dispatch == 6 and crash.replica == 0
    assert slow.at_dispatch == 4 and slow.until == 12 \
        and slow.delay_s == pytest.approx(0.002) and slow.replica == 1
    assert pool.at_step == 8 and pool.until == 40 and pool.blocks == 4
    assert nan.at_dispatch == 3
    assert expire.at_step == 10 and expire.replica is None
    assert plan.seed == 3


def test_plan_json_roundtrip():
    plan = parse_plan("crash@d6:r0,slow@d4-12:r1:2ms,pool@s8-40:r0:4",
                      seed=9)
    assert FaultPlan.from_json(plan.to_json()) == plan


def test_plan_validation():
    with pytest.raises(ValueError):
        FaultSpec("crash")                       # needs at_dispatch
    with pytest.raises(ValueError):
        FaultSpec("straggler", at_dispatch=1)    # needs until
    with pytest.raises(ValueError):
        FaultSpec("frobnicate", at_step=1)       # unknown kind
    with pytest.raises(ValueError):
        parse_plan("crash@x3")                   # bad clock letter


def test_resolve_targets_is_seeded_and_stable():
    plan = parse_plan("crash@d2,slow@d1-4:1ms", seed=5)
    a = resolve_targets(plan, 4)
    b = resolve_targets(plan, 4)
    assert a == b                                # same seed, same pinning
    assert all(f.replica is not None and 0 <= f.replica < 4 for f in a)
    other = resolve_targets(parse_plan("crash@d2,slow@d1-4:1ms", seed=6), 4)
    assert [f.replica for f in a] != [f.replica for f in other] or True


# ------------------------------------------- crash, probation, rejoin

def test_crash_recovers_outputs_and_replica_rejoins(model, oracle):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=64,
                       policy="round-robin", probation_seconds=0.05)
    inj = FaultInjector(parse_plan("crash@d1:r0")).arm(gw)
    reqs = [gw.submit(p, max_new_tokens=4) for p in PROMPTS]
    gw.run()
    assert inj.count("crash") == 1
    assert all(r.done for r in reqs)
    assert [r.output for r in reqs] == oracle    # retries changed nothing
    r0 = gw.replicas[0]
    assert r0.failures == 1
    # probation may outlast the (tiny) workload; drive the clock
    time.sleep(0.06)
    gw.step()
    assert r0.healthy and r0.reintegrations == 1
    inj.disarm()
    assert "step" not in vars(gw)                # wrappers removed
    assert "step" not in vars(r0.engine)
    # the rejoined replica actually serves (round-robin must place on it)
    more = [gw.submit(p, max_new_tokens=3) for p in PROMPTS]
    gw.run()
    assert all(m.done for m in more)
    assert any(m.metrics.replica_id == 0 for m in more)


def test_straggler_slows_but_never_corrupts(model, oracle):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=4, cache_len=64)
    with FaultInjector(parse_plan("slow@d0-4:r0:1ms")).arm(gw):
        reqs = [gw.submit(p, max_new_tokens=4) for p in PROMPTS]
        gw.run()
        assert [r.output for r in reqs] == oracle
    inj_fired = gw.summary()["retried"]
    assert inj_fired == 0                        # slow is not dead


def test_pool_pressure_defers_dispatch_without_loss(model, oracle):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=32,
                       kv_layout="paged", block_size=4)
    pool = gw.replicas[0].engine.manager.pool
    # hold all but one block over gateway steps [0, 6): nothing fits
    inj = FaultInjector(
        parse_plan(f"pool@s0-6:r0:{pool.n_blocks - 1}")).arm(gw)
    reqs = [gw.submit(p, max_new_tokens=4) for p in PROMPTS[:2]]
    for _ in range(3):                           # inside the window
        gw.step()
        assert len(gw._inflight) == 0            # deferred, not failed
    gw.run()                                     # window closes, serves
    inj.disarm()
    assert [r.output for r in reqs] == oracle[:2]
    assert inj.count("pool_pressure") >= 2       # hold + release recorded
    pool.check_invariants()
    assert pool.free_count() > 0


def test_nan_logits_fails_only_the_sampled_request(model):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=64)
    inj = FaultInjector(parse_plan("nan@d0:r0")).arm(gw)
    # only non-greedy requests sample host-side, so the first _sample_safe
    # call is deterministically the sampled request's
    sampled = gw.submit(PROMPTS[0], max_new_tokens=4,
                        sampling=SamplingParams(temperature=0.7, seed=3))
    greedy = gw.submit(PROMPTS[1], max_new_tokens=4)
    gw.run()
    inj.disarm()
    assert inj.count("nan_logits") == 1
    assert sampled.status == "failed" and sampled.error is not None
    assert greedy.done and gw.replicas[0].healthy
    assert gw.summary()["retried"] == 0          # request-scoped, no nack


# --------------------------------------------------- lease-expiry faults

def test_forced_lease_expiry_no_double_delivery(model, oracle):
    params, cfg = model
    # free slots left open on purpose: the dispatch loop keeps pulling, so
    # the forced expiry is *observed* by queue.get() (with a full replica
    # the pre-dispatch extend would heal it before any get could run)
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=4, cache_len=64)
    seen = {}
    inj = FaultInjector(parse_plan("expire@s1")).arm(gw)
    reqs = [gw.submit(p, max_new_tokens=4,
                      on_token=seen.setdefault(i, []).append)
            for i, p in enumerate(PROMPTS[:2])]
    gw.run()
    inj.disarm()
    assert inj.count("lease_expiry") == 1
    assert gw.queue.stats()["expired"] >= 1      # the fault was observed
    assert gw.summary()["retried"] == 0          # but never double-placed
    for i, r in enumerate(reqs):
        assert r.done and seen[i] == r.output    # delivered exactly once
    assert [r.output for r in reqs] == oracle[:2]


def test_mid_step_lease_lapse_is_healed_before_observation(model, oracle):
    """Regression (satellite 1): a lease shorter than one engine dispatch
    must never be observed as expired — leases are extended immediately
    before each dispatch and re-healed after the replica loop, so the
    queue cannot redeliver a still-running request."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=64,
                       lease_seconds=0.05)
    # two 120 ms dispatches, each > 2x the lease
    inj = FaultInjector(parse_plan("slow@d1-3:r0:120ms")).arm(gw)
    seen = {}
    reqs = [gw.submit(p, max_new_tokens=4,
                      on_token=seen.setdefault(i, []).append)
            for i, p in enumerate(PROMPTS[:2])]
    gw.run()
    inj.disarm()
    assert inj.count("straggler") == 2
    assert gw.queue.stats()["expired"] == 0      # lapse healed, unobserved
    assert gw.summary()["retried"] == 0
    for i, r in enumerate(reqs):
        assert r.done and seen[i] == r.output and len(r.output) == 4
    assert [r.output for r in reqs] == oracle[:2]


# ----------------------------------------------------- stream semantics

def test_stream_restart_replays_exactly_once(model, oracle):
    """Satellite 2: a crash after tokens were already delivered must
    surface an explicit `restarted` event and swallow the replayed prefix
    — the consumer-visible stream equals the final output exactly once."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=64,
                       policy="round-robin")
    inj = FaultInjector(parse_plan("crash@d3:r0")).arm(gw)
    seen = {}
    reqs = [gw.submit(p, max_new_tokens=6,
                      on_token=seen.setdefault(i, []).append)
            for i, p in enumerate(PROMPTS)]
    gw.run()
    inj.disarm()
    restarted = [r for r in reqs if r.stream.restarts > 0]
    assert restarted                             # the crash hit someone
    assert any(ev["visible_tokens"] > 0
               for r in restarted for ev in r.stream.events
               if ev["event"] == "restarted")    # mid-stream, not at t=0
    for i, r in enumerate(reqs):
        assert r.done and len(r.output) == 6
        assert seen[i] == r.output               # no duplicated prefix
    assert not gw.replicas[0].healthy and gw.replicas[1].healthy


def test_poison_request_is_quarantined_not_serially_fatal(model):
    """A request that kills `poison_threshold` distinct replicas is buried
    as failed(poison); after probation the fleet serves again."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=64,
                       policy="round-robin", probation_seconds=0.05,
                       poison_threshold=2)
    inj = FaultInjector(parse_plan("crash@d0:r0,crash@d0:r1")).arm(gw)
    poison = gw.submit(PROMPTS[0], max_new_tokens=4)
    gw.run()
    inj.disarm()
    assert inj.count("crash") == 2
    assert poison.status == "failed"
    assert poison.stream.finish_reason == "poison"
    assert gw.queue.stats()["dead"] == 1         # buried, not redeliverable
    time.sleep(0.06)
    later = gw.submit(PROMPTS[1], max_new_tokens=3)
    gw.run()
    assert later.done                            # fleet recovered
    assert all(r.healthy and r.reintegrations == 1 for r in gw.replicas)


# ------------------------------------------------------------- brownout

def test_brownout_ladder_sheds_batch_then_degrades_then_recovers(model):
    params, cfg = model
    slo = SLOTracker()
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=1, cache_len=32,
                       kv_layout="paged", block_size=4,
                       scheduler="chunked", chunk_budget=8,
                       slo=slo,
                       brownout=BrownoutConfig(depth_high=2,
                                               escalate_steps=1,
                                               cool_steps=2,
                                               shed_tier_min=2,
                                               chunk_cap=4))
    eng = gw.replicas[0].engine
    batch = [gw.submit(p, max_new_tokens=3, tier=2, tenant="batchco")
             for p in PROMPTS]
    premium = gw.submit(PROMPTS[0], max_new_tokens=3, tier=0,
                        tenant="prem")
    gw.run()
    # batch-tier intake was shed with an explicit 503, premium untouched
    assert premium.done
    shed = [b for b in batch if b.status == "rejected"]
    assert shed and all(b.stream.finish_reason == "brownout"
                        and b.stream.status_code == 503 for b in shed)
    assert slo.report()["tiers"][2]["shed_brownout_503"] == len(shed)
    assert (0, 1) in gw.brownout.transitions
    if gw.brownout.level >= 2:                   # sustained pressure
        assert eng.degraded
        assert eng.scheduler.metrics()["chunk_cap"] == 4
    # drain + idle steps cool the ladder back to normal operation
    for _ in range(12):
        gw.step()
    assert gw.brownout.level == 0
    assert not eng.degraded
    assert eng.scheduler.metrics()["chunk_cap"] is None
    late = gw.submit(PROMPTS[1], max_new_tokens=3, tier=2)
    gw.run()
    assert late.done                             # batch tier restored


def test_brownout_level2_reaches_engine_degradation(model):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=1, cache_len=32,
                       kv_layout="paged", block_size=4,
                       brownout=BrownoutConfig(depth_high=1,
                                               escalate_steps=1,
                                               cool_steps=50,
                                               shed_tier_min=2))
    reqs = [gw.submit(p, max_new_tokens=3, tier=0) for p in PROMPTS * 2]
    gw.run()
    assert all(r.done for r in reqs)             # premium never shed
    assert (1, 2) in gw.brownout.transitions     # ladder reached level 2
    assert gw.replicas[0].engine.degraded        # cool_steps=50: still on


# ----------------------------------------------- engine warm reset

def test_engine_reset_restores_a_clean_warm_replica(model, oracle):
    params, cfg = model
    eng = ServeEngine(params, cfg, device="cpu", batch_slots=2, cache_len=32,
                      kv_layout="paged", block_size=4)
    first = [eng.submit(p, max_new_tokens=4) for p in PROMPTS]
    eng.run()
    assert [r.output for r in first] == oracle
    eng.reset()
    pool = eng.manager.pool
    # everything back in the free list (block 0 is the reserved null)
    assert pool.free_count() == pool.n_blocks - 1
    assert all(s is None for s in eng.active)
    again = [eng.submit(p, max_new_tokens=4) for p in PROMPTS]
    eng.run()                                    # no recompile stall/crash
    assert [r.output for r in again] == oracle
    pool.check_invariants()


def test_degraded_engine_skips_fast_lanes_with_identical_outputs(model,
                                                                 oracle):
    params, cfg = model
    eng = ServeEngine(params, cfg, device="cpu", batch_slots=2, cache_len=32,
                      kv_layout="paged", block_size=4,
                      spec_tokens=3, drafter="ngram")
    eng.set_degraded(True)
    reqs = [eng.submit(p, max_new_tokens=4) for p in PROMPTS]
    eng.run()
    assert [r.output for r in reqs] == oracle
    sm = eng.spec_metrics
    assert sm["tokens_accepted"] == 0            # spec lane never ran
    eng.set_degraded(False)
    assert not eng.degraded


# -------------------------------- crash parity across all decode paths

@pytest.mark.parametrize("path", sorted(PATHS))
def test_crash_parity_across_decode_paths(model, path):
    """A mid-run crash + retry must be output-invisible on every decode
    path — the same contract test_decode_parity holds fault-free."""
    params, cfg = model
    kw = dict(PATHS[path])
    if kw.get("kv_layout") == "paged":
        kw["block_size"] = 4
    solo = []
    for p in PROMPTS:
        eng = ServeEngine(params, cfg, device="cpu",
                          batch_slots=1, cache_len=32, **kw)
        r = eng.submit(p, max_new_tokens=8)
        eng.run()
        solo.append(r.output)
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=32,
                       policy="round-robin", probation_seconds=0.05, **kw)
    # 8 new tokens so even the fused path (4-token bursts) needs several
    # dispatches — dispatch 1 is mid-run on every path
    with FaultInjector(parse_plan("crash@d1:r0", seed=1)).arm(gw) as inj:
        reqs = [gw.submit(p, max_new_tokens=8) for p in PROMPTS]
        gw.run()
        assert inj.count("crash") == 1
    assert all(r.done for r in reqs)
    assert [r.output for r in reqs] == solo
