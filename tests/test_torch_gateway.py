"""The port's gateway, in two halves.

The first is the port's copy of tests/test_gateway.py, case for case:
repro_torch's tiny-config engines on the CPU (seeded torch weights,
`device="cpu"`). The second, at the end, holds the port's Gateway against
the JAX Gateway on the same inputs: reduced qwen3-1.7b with the
reference's `init_lm(PRNGKey(0))` weights bridged over, two replicas on
the paged layout, the synchronous mode, every dispatch policy, greedy and
seeded-sampled; each request's tokens, replica, final status and 429
rejection must be the reference's. The reference's docstring of the first
half follows.

Gateway subsystem: queue-backed admission, dispatch policies, deadlines,
replica failure/retry, streaming, and telemetry."""
import json
import os
import time

import pytest
import torch

from _torch_host import one_torch_thread, shut_down_gateways  # noqa: F401
from repro_torch.configs.base import ModelConfig
from repro_torch.gateway.gateway import (POLICIES, Gateway, LeastLoaded,
                                         PrefixAffinity, RoundRobin)
from repro_torch.gateway.sampler import SamplingParams
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

V = 41
PROMPTS = [[3, 1, 4, 1], [5, 9, 2], [6, 5, 3, 5], [8, 9, 7]]


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig("t", "dense", 2, 32, 2, 2, 64, V)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    return params, cfg


def _solo_outputs(params, cfg, prompts, n_new=4):
    outs = []
    for p in prompts:
        eng = ServeEngine(params, cfg, device="cpu",
                          batch_slots=1, cache_len=64)
        r = eng.submit(p, max_new_tokens=n_new)
        eng.run()
        outs.append(r.output)
    return outs


# ------------------------------------------------------------ policy units

class _StubReplica:
    def __init__(self, replica_id, load):
        self.replica_id = replica_id
        self._load = load

    def load(self):
        return self._load


class _StubSpec:
    def __init__(self, prompt):
        self.payload = {"prompt": prompt}


def test_round_robin_rotates():
    pol = RoundRobin()
    reps = [_StubReplica(0, 0), _StubReplica(1, 0)]
    picks = [pol.choose(reps, _StubSpec([1]), reps).replica_id
             for _ in range(4)]
    assert picks == [0, 1, 0, 1]


def test_least_loaded_picks_min_load():
    pol = LeastLoaded()
    reps = [_StubReplica(0, 3), _StubReplica(1, 1), _StubReplica(2, 2)]
    assert pol.choose(reps, _StubSpec([1]), reps).replica_id == 1


def test_prefix_affinity_same_prefix_same_replica():
    pol = PrefixAffinity(prefix_len=4)
    reps = [_StubReplica(i, 0) for i in range(3)]
    a = pol.choose(reps, _StubSpec([1, 2, 3, 4, 9]), reps)
    b = pol.choose(reps, _StubSpec([1, 2, 3, 4, 77]), reps)
    assert a.replica_id == b.replica_id          # shared 4-token prefix
    # preferred replica full -> falls back to least-loaded, still serves
    want = pol.preferred_id([1, 2, 3, 4], 3)
    eligible = [r for r in reps if r.replica_id != want]
    c = pol.choose(eligible, _StubSpec([1, 2, 3, 4]), reps)
    assert c.replica_id != want


def test_policy_registry_names():
    assert set(POLICIES) == {"round-robin", "least-loaded",
                             "prefix-affinity"}


# ------------------------------------------------------------- end to end

@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_gateway_matches_solo_outputs_under_every_policy(model, policy):
    """Routing/queueing must never change what a greedy request decodes."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=64,
                       policy=policy)
    reqs = [gw.submit(p, max_new_tokens=4) for p in PROMPTS]
    done = gw.run()
    assert len(done) == len(PROMPTS)
    assert [r.output for r in reqs] == _solo_outputs(params, cfg, PROMPTS)
    assert all(r.status == "done" for r in reqs)


def test_round_robin_spreads_across_replicas(model):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=64,
                       policy="round-robin")
    reqs = [gw.submit(p, max_new_tokens=3) for p in PROMPTS]
    gw.run()
    placed = sorted(r.replica_id for r in reqs)
    assert placed == [0, 0, 1, 1]


def test_priority_dispatch_order(model):
    """One slot total: the high-priority request must decode first even
    though it was submitted last."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=1, cache_len=64)
    low = [gw.submit(p, max_new_tokens=3, priority=0) for p in PROMPTS[:2]]
    high = gw.submit(PROMPTS[2], max_new_tokens=3, priority=9)
    gw.run()
    assert high.metrics.dispatch_t < min(r.metrics.dispatch_t for r in low)
    assert high.done and all(r.done for r in low)


def test_deadline_rejected_without_decode(model):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=1, cache_len=64)
    ok = gw.submit(PROMPTS[0], max_new_tokens=3)
    late = gw.submit(PROMPTS[1], max_new_tokens=3, timeout_s=-1.0)
    done = gw.run()
    assert [g.gid for g in done] == [ok.gid]
    assert late.status == "rejected" and late.output == []
    assert list(late.stream) == []               # stream terminates cleanly
    assert gw.summary()["rejected"] == 1


def test_replica_failure_retries_on_survivor(model):
    """Dispensable workers: a replica that throws mid-decode loses its
    lease; the queue redelivers to the surviving replica and outputs are
    unchanged."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=64,
                       policy="round-robin")

    def boom():
        raise RuntimeError("injected replica crash")
    gw.replicas[0].engine.step = boom

    reqs = [gw.submit(p, max_new_tokens=4) for p in PROMPTS]
    done = gw.run()
    assert not gw.replicas[0].healthy and gw.replicas[1].healthy
    assert len(done) == len(PROMPTS)
    assert [r.output for r in reqs] == _solo_outputs(params, cfg, PROMPTS)
    assert all(r.replica_id == 1 for r in reqs)
    assert gw.summary()["retried"] >= 1


def test_all_replicas_down_fails_cleanly(model):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=1, cache_len=64)

    def boom():
        raise RuntimeError("crash")
    gw.replicas[0].engine.step = boom
    reqs = [gw.submit(p, max_new_tokens=3) for p in PROMPTS[:2]]
    done = gw.run()                              # must terminate
    assert done == []
    assert all(r.status == "failed" for r in reqs)
    assert all(r.stream.finished for r in reqs)


def test_abort_is_idempotent_across_lease_expiries(model):
    """With all replicas down and tiny leases, repeated step() calls must
    not re-fail the same task or fabricate phantom adopted requests."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=1, cache_len=64,
                       lease_seconds=1e-4)

    def boom():
        raise RuntimeError("crash")
    gw.replicas[0].engine.step = boom
    gw.submit(PROMPTS[0], max_new_tokens=3)
    gw.run()
    assert gw.summary()["failed"] == 1
    gw.reap()
    for _ in range(5):                           # leases expired, redelivered
        time.sleep(0.001)
        gw.step()
    assert gw.summary()["failed"] == 1           # no re-fail
    assert gw.requests() == []                   # no phantom adoptions


def test_streaming_yields_tokens_before_completion(model):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=64)
    r = gw.submit(PROMPTS[0], max_new_tokens=6)
    it = iter(r.stream)
    first = next(it)                             # pumps the gateway
    assert not r.finished                        # still decoding
    rest = list(it)
    assert r.done
    assert [first] + rest == r.output
    assert len(r.output) == 6


def test_streaming_callback_fires_per_token(model):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=64)
    seen = []
    r = gw.submit(PROMPTS[1], max_new_tokens=5, on_token=seen.append)
    gw.run()
    assert seen == r.output


def test_per_request_sampling_through_gateway(model):
    """Two requests with different SamplingParams share a batch; the seeded
    one reproduces its solo decode."""
    params, cfg = model
    stoch = SamplingParams(temperature=0.8, top_k=12, seed=7)
    solo_eng = ServeEngine(params, cfg, device="cpu",
                           batch_slots=1, cache_len=64)
    solo = solo_eng.submit(PROMPTS[0], max_new_tokens=5, sampling=stoch)
    solo_eng.run()
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=64)
    a = gw.submit(PROMPTS[0], max_new_tokens=5, sampling=stoch)
    b = gw.submit(PROMPTS[0], max_new_tokens=5)  # greedy peer, same prompt
    gw.run()
    assert a.output == solo.output
    assert b.output == _solo_outputs(params, cfg, [PROMPTS[0]], 5)[0]


def test_journal_reuse_does_not_swallow_new_requests(model, tmp_path):
    """Two gateway runs sharing one journal: run 2's submissions must get
    fresh task ids (per-run nonce), not collide with run 1's acked ones."""
    params, cfg = model
    journal = os.path.join(tmp_path, "reuse.journal")
    gw1 = Gateway.build(params, cfg, device="cpu",
                        replicas=1, batch_slots=2, cache_len=64,
                        journal_path=journal)
    for p in PROMPTS[:2]:
        gw1.submit(p, max_new_tokens=3)
    assert len(gw1.run()) == 2
    gw1.queue.close()
    gw2 = Gateway.build(params, cfg, device="cpu",
                        replicas=1, batch_slots=2, cache_len=64,
                        journal_path=journal)
    reqs = [gw2.submit(p, max_new_tokens=3) for p in PROMPTS[:2]]
    assert len(gw2.run()) == 2
    assert all(r.done and len(r.output) == 3 for r in reqs)


def test_journal_crash_recovery_adopts_pending(model, tmp_path):
    """Tasks journaled by a gateway that died before serving them are
    replayed and adopted by the next gateway process."""
    params, cfg = model
    journal = os.path.join(tmp_path, "crash.journal")
    gw1 = Gateway.build(params, cfg, device="cpu",
                        replicas=1, batch_slots=2, cache_len=64,
                        journal_path=journal)
    for p in PROMPTS[:2]:
        gw1.submit(p, max_new_tokens=4)
    gw1.queue.close()                            # "crash" before any step
    gw2 = Gateway.build(params, cfg, device="cpu",
                        replicas=1, batch_slots=2, cache_len=64,
                        journal_path=journal)
    done = gw2.run()                             # adopts replayed tasks
    assert len(done) == 2
    assert sorted(len(r.output) for r in done) == [4, 4]
    outs = {tuple(r.prompt): r.output for r in done}
    solo = _solo_outputs(params, cfg, PROMPTS[:2])
    assert [outs[tuple(p)] for p in PROMPTS[:2]] == solo


def test_adopted_tasks_fail_cleanly_when_all_replicas_down(model, tmp_path):
    """Journal-recovered tasks + total replica loss: run() must terminate
    with clean 'failed' statuses, not KeyError on the prior run's gids."""
    params, cfg = model
    journal = os.path.join(tmp_path, "abort.journal")
    gw1 = Gateway.build(params, cfg, device="cpu",
                        replicas=1, batch_slots=2, cache_len=64,
                        journal_path=journal)
    for p in PROMPTS[:3]:
        gw1.submit(p, max_new_tokens=3)
    gw1.queue.close()
    gw2 = Gateway.build(params, cfg, device="cpu",
                        replicas=1, batch_slots=2, cache_len=64,
                        journal_path=journal)

    def boom():
        raise RuntimeError("crash")
    gw2.replicas[0].engine.step = boom
    done = gw2.run()                             # must not raise
    assert done == []
    assert all(g.status == "failed" for g in gw2.requests())
    # abort must NOT ack: a restarted gateway with the same journal (and a
    # working replica) still redelivers and serves every request
    gw2.queue.close()
    gw3 = Gateway.build(params, cfg, device="cpu",
                        replicas=1, batch_slots=2, cache_len=64,
                        journal_path=journal)
    assert len(gw3.run()) == 3


def test_nacked_adopted_task_is_not_duplicated(model, tmp_path):
    """A journal-recovered task whose replica crashes must be redelivered
    to the same handle, not re-adopted as a duplicate request."""
    params, cfg = model
    journal = os.path.join(tmp_path, "readopt.journal")
    gw1 = Gateway.build(params, cfg, device="cpu",
                        replicas=1, batch_slots=2, cache_len=64,
                        journal_path=journal)
    for p in PROMPTS[:2]:
        gw1.submit(p, max_new_tokens=3)
    gw1.queue.close()
    gw2 = Gateway.build(params, cfg, device="cpu",
                        replicas=2, batch_slots=1, cache_len=64,
                        policy="round-robin", journal_path=journal)

    def boom():
        raise RuntimeError("crash")
    gw2.replicas[0].engine.step = boom
    done = gw2.run()
    assert len(done) == 2                        # both served by replica 1
    assert len(gw2.requests()) == 2              # no duplicate handles
    assert gw2.summary()["n_requests"] == 2
    assert all(g.done for g in gw2.requests())


def test_expired_lease_does_not_double_place(model):
    """A lease that expires mid-decode (every step, with this lease) must
    not re-place the still-running request: tokens stream exactly once."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=1, cache_len=64,
                       lease_seconds=1e-4)
    seen = {}
    reqs = [gw.submit(p, max_new_tokens=4,
                      on_token=seen.setdefault(i, []).append)
            for i, p in enumerate(PROMPTS[:2])]
    gw.run()
    for i, r in enumerate(reqs):
        assert r.done and seen[i] == r.output and len(r.output) == 4
    assert gw.summary()["retried"] == 0          # no duplicate dispatches
    assert gw.summary()["n_requests"] == 2


def test_poison_request_fails_alone_replica_survives(model):
    """A request whose host-side sampling raises must fail by itself; its
    batch peers and the replica keep serving."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=64)
    poison = gw.submit(PROMPTS[0], max_new_tokens=4,
                       sampling=SamplingParams(temperature=0.5, seed=1))
    ok = gw.submit(PROMPTS[1], max_new_tokens=4)
    gw.step()                          # dispatch + first decode

    def explode(logits):
        raise ValueError("NaN probs")
    poison.engine_req._sampler.sample = explode
    gw.run()
    assert ok.done and not poison.done
    assert poison.status == "failed"
    assert isinstance(poison.error, ValueError)
    assert gw.replicas[0].healthy      # replica not blamed
    assert gw.summary()["retried"] == 0
    later = gw.submit(PROMPTS[2], max_new_tokens=3)
    gw.run()
    assert later.done                  # gateway still serving


def test_callback_exception_does_not_poison_replicas(model):
    """A client on_token callback that raises must not read as replica
    failure: decoding completes, replicas stay healthy, and the error is
    preserved on the stream."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=64)

    def bad_callback(tok):
        raise BrokenPipeError("client went away")
    broken = gw.submit(PROMPTS[0], max_new_tokens=4, on_token=bad_callback)
    ok = gw.submit(PROMPTS[1], max_new_tokens=4)
    done = gw.run()
    assert len(done) == 2 and broken.done and ok.done
    assert all(r.healthy for r in gw.replicas)
    assert isinstance(broken.stream.callback_error, BrokenPipeError)
    assert gw.summary()["retried"] == 0
    assert broken.output == _solo_outputs(params, cfg, [PROMPTS[0]])[0]


def test_direct_engine_run_after_gateway_wiring(model):
    """Engines handed to a Gateway (which disables retain_finished) must
    still return results from a direct ServeEngine.run()."""
    params, cfg = model
    eng = ServeEngine(params, cfg, device="cpu", batch_slots=2, cache_len=64)
    Gateway([eng])                               # wires hooks, disables retain
    r = eng.submit(PROMPTS[0], max_new_tokens=3)
    done = eng.run()
    assert done == [r] and len(r.output) == 3
    assert eng._finished == []                   # nothing retained after


def test_reap_bounds_retention_and_keeps_serving(model):
    """A long-lived gateway releases terminal handles via reap(); aggregate
    counters survive and the gateway keeps serving afterwards."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=64)
    first = [gw.submit(p, max_new_tokens=3) for p in PROMPTS[:2]]
    gw.run()
    reaped = gw.reap()
    assert sorted(g.gid for g in reaped) == [g.gid for g in first]
    assert gw.requests() == []                   # maps released
    assert first[0].output                       # caller's handle still live
    later = gw.submit(PROMPTS[2], max_new_tokens=3)
    gw.run()
    assert later.done
    assert gw.summary()["completed"] == 3        # counters accumulate


def test_metrics_and_dashboard(model, tmp_path):
    from repro_torch.core import reporting
    params, cfg = model
    journal = os.path.join(tmp_path, "gw.journal")
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=64,
                       journal_path=journal)
    for p in PROMPTS:
        gw.submit(p, max_new_tokens=4)
    gw.run()
    s = gw.summary()
    assert s["completed"] == len(PROMPTS)
    assert s["total_tokens"] == 4 * len(PROMPTS)
    assert s["throughput_tok_s"] > 0
    assert s["ttft_p50_ms"] <= s["ttft_p99_ms"]
    assert 0 < s["mean_slot_utilization"] <= 1
    dash = reporting.gateway_dashboard(s, gw.metrics.gauges)
    assert "queue depth" in dash and "active slots" in dash
    # durable intake: the journal recorded every put and ack
    ops = [json.loads(line)["op"] for line in open(journal)]
    assert ops.count("put") == len(PROMPTS)
    assert ops.count("ack") == len(PROMPTS)


# ------------------------------------------------- against the JAX gateway
#
# A shared 12-token prefix (prefix-affinity and radix reuse), prompts of
# other lengths, and one whose prompt plus budget exceeds the fleet's
# token budget (a 429 at submit). The budget of 48 committed tokens also
# holds admissible requests back until earlier ones retire.
SHARED = [7, 3, 9, 1, 4, 4, 8, 2, 6, 5, 11, 13]
PARITY_PROMPTS = [SHARED + [21], [30, 31, 32, 33, 34], SHARED + [22, 23],
                  list(range(100, 140)), [50, 51, 52, 53, 54, 55, 56, 57],
                  SHARED + [24], [60, 61, 62]]
PARITY_NEW = [6, 7, 5, 12, 8, 6, 9]
ADMIT_BUDGET = 48


@pytest.fixture(scope="module")
def bridged():
    pytest.importorskip("jax")
    from _torch_parity import bridged_model
    return bridged_model()


def _serve_fleet(gateway_cls, sampling_cls, params, cfg, policy, sampled,
                 **kw):
    """Serve PARITY_PROMPTS through a two-replica paged gateway; returns
    per request (tokens, replica, status, finish reason, status code) and
    the summary's rejection count."""
    gw = gateway_cls.build(params, cfg, replicas=2, batch_slots=2,
                           cache_len=64, kv_layout="paged", block_size=8,
                           policy=policy, admit_budget=ADMIT_BUDGET, **kw)
    reqs = []
    for i, (p, n) in enumerate(zip(PARITY_PROMPTS, PARITY_NEW)):
        sp = sampling_cls(temperature=0.9, top_k=16, seed=100 + i) \
            if sampled and i % 2 else None
        reqs.append(gw.submit(p, max_new_tokens=n, sampling=sp))
    gw.run()
    return ([(r.output, r.replica_id, r.status, r.stream.finish_reason,
              r.stream.status_code) for r in reqs],
            gw.summary()["rejected"])


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_gateway_matches_jax_gateway(bridged, policy, sampled):
    from repro.gateway.gateway import Gateway as JaxGateway
    from repro.gateway.sampler import SamplingParams as JaxSampling
    jcfg, tcfg, jparams, tparams = bridged
    want = _serve_fleet(JaxGateway, JaxSampling, jparams, jcfg, policy,
                        sampled)
    got = _serve_fleet(Gateway, SamplingParams, tparams, tcfg, policy,
                       sampled, device="cpu")
    assert got == want
    per_request, rejected = got
    assert rejected == 1 and per_request[3][2:] == ("rejected",
                                                    "over_capacity", 429)
    assert all(r[2] == "done" and len(r[0]) == n
               for r, n in zip(per_request, PARITY_NEW) if r[2] != "rejected")
    assert {r[1] for r in per_request if r[1] is not None} == {0, 1}
