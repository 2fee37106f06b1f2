"""The port's copy of tests/test_slo.py, case for case:
repro_torch's tiny-config engines on the CPU (seeded torch weights,
`device="cpu"`). The reference's docstring follows.

Multi-tenant SLO observability: workload harness, tracker, recorder.

Covers the seeded trace-driven workload generator (determinism, burst
shaping, JSON trace round-trip), SLOSpec judgment and SLOTracker
accounting over the lifecycle-observer stream, the anomaly flight
recorder (breach / illegal-transition / shed-spike / replica-failure
dumps that are Perfetto-schema-valid and contain the offending request's
spans), the tenant/tier threading through gateway submit -> metrics ->
trace args -> journal adoption, and the parity contract: arming the
whole stack must not change one token on any decode path.
"""
import json
import os

import pytest
import torch

from _torch_host import one_torch_thread, shut_down_gateways  # noqa: F401
from repro_torch.configs.base import ModelConfig
from repro_torch.core import reporting
from repro_torch.gateway.gateway import Gateway
from repro_torch.gateway.metrics import GatewayMetrics, RequestMetrics
from repro_torch.models import transformer as T
from repro_torch.obs import trace as otrace
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.slo import DEFAULT_TIER_SLOS, SLOSpec, SLOTracker, \
    load_slos, save_slos
from repro_torch.obs import workload as owl

from test_torch_obs import PATHS, PROMPTS, _assert_trace_schema

V = 41


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig("t", "dense", 2, 32, 2, 2, 64, V)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    return params, cfg


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    otrace.disable()
    yield
    otrace.disable()


def _spec(**kw):
    base = dict(seed=3, duration_s=1.0, base_rate_rps=30.0,
                prompt_len_max=16, output_len_max=6, vocab_size=V)
    base.update(kw)
    return owl.WorkloadSpec(**base)


# ----------------------------------------------------- workload generator

class TestWorkloadGenerator:
    def test_deterministic(self):
        a, b = owl.generate(_spec()), owl.generate(_spec())
        assert a and a == b
        assert owl.generate(_spec(seed=4)) != a

    def test_shapes_respect_spec(self):
        spec = _spec(deadline_s_by_tier={2: 5.0})
        prefix_by_tenant = {t.name: t.prefix_len for t in spec.tenants}
        tier_by_tenant = {t.name: t.tier for t in spec.tenants}
        for r in owl.generate(spec):
            assert 0.0 <= r.arrival_s < spec.duration_s
            assert r.tenant in prefix_by_tenant
            assert r.tier == tier_by_tenant[r.tenant]
            assert 1 <= len(r.prompt) <= \
                spec.prompt_len_max + prefix_by_tenant[r.tenant]
            assert 1 <= r.max_new_tokens <= spec.output_len_max
            assert all(0 <= t < V for t in r.prompt)
            assert r.deadline_s == (5.0 if r.tier == 2 else None)

    def test_tenant_prefix_is_shared_and_stable(self):
        reqs = owl.generate(_spec())
        by_tenant = {}
        for r in reqs:
            by_tenant.setdefault(r.tenant, []).append(r.prompt)
        for t in _spec().tenants:
            prompts = by_tenant.get(t.name, [])
            for p in prompts:
                k = min(t.prefix_len, len(p))
                assert p[:k] == prompts[0][:k]

    def test_burst_window_is_denser(self):
        spec = _spec(duration_s=4.0, base_rate_rps=25.0, burst_mult=5.0)
        reqs = owl.generate(spec)
        t0 = spec.burst_start_frac * spec.duration_s
        t1 = spec.burst_end_frac * spec.duration_s
        inside = [r for r in reqs if t0 <= r.arrival_s < t1]
        outside = [r for r in reqs if not (t0 <= r.arrival_s < t1)]
        rate_in = len(inside) / (t1 - t0)
        rate_out = len(outside) / (spec.duration_s - (t1 - t0))
        assert rate_in > 1.5 * rate_out

    def test_trace_round_trip(self, tmp_path):
        spec = _spec(deadline_s_by_tier={1: 2.0})
        reqs = owl.generate(spec)
        path = owl.save_trace(tmp_path / "w.json", reqs, spec)
        assert owl.load_trace(path) == reqs
        doc = json.loads(path.read_text())
        assert doc["version"] == owl.TRACE_VERSION
        assert doc["spec"]["seed"] == spec.seed       # provenance rides along

    def test_load_trace_rejects_garbage(self, tmp_path):
        bad = tmp_path / "bad.json"
        bad.write_text("{\"rows\": []}")
        with pytest.raises(ValueError, match="not a workload trace"):
            owl.load_trace(bad)
        newer = tmp_path / "newer.json"
        newer.write_text(json.dumps(
            {"version": owl.TRACE_VERSION + 1, "requests": []}))
        with pytest.raises(ValueError, match="newer"):
            owl.load_trace(newer)

    def test_tier_priority_orders_premium_first(self):
        assert owl.tier_priority(0) > owl.tier_priority(1) \
            > owl.tier_priority(2)


# ------------------------------------------------------------ SLO judging

def _req(ttft=0.01, itls=(0.002, 0.003), tier=0, tenant="acme",
         status="done", reason=None, rid=0):
    """A terminal RequestMetrics shaped by hand (times in seconds)."""
    m = RequestMetrics(rid, prompt_len=4, submit_t=100.0, tenant=tenant,
                       tier=tier)
    t = 100.0 + (ttft if ttft is not None else 0.0)
    if ttft is not None:
        m.first_token_t = t
        m.token_ts.append(t)
        for gap in itls:
            t += gap
            m.token_ts.append(t)
    m.finish_t = t + 0.001
    m.status = status
    m.finish_reason = reason
    return m


class TestSLOSpec:
    def test_none_targets_never_violate(self):
        assert SLOSpec("batch").violations(_req(ttft=None)) == []

    def test_each_target_fires_by_name(self):
        spec = SLOSpec("tight", ttft_ms=5.0, itl_p95_ms=1.0, stall_ms=2.0,
                       deadline_ms=4.0)
        v = spec.violations(_req(ttft=0.5, itls=(0.5, 0.9)))
        assert v == ["ttft_ms", "itl_p95_ms", "stall_ms", "deadline_ms"]
        ok = SLOSpec("loose", ttft_ms=5_000.0, itl_p95_ms=5_000.0,
                     stall_ms=5_000.0, deadline_ms=60_000.0)
        assert ok.violations(_req()) == []

    def test_missing_first_token_violates_ttft(self):
        assert SLOSpec("t", ttft_ms=1e9).violations(_req(ttft=None)) \
            == ["ttft_ms"]

    def test_slos_file_round_trip(self, tmp_path):
        path = save_slos(tmp_path / "slos.json", DEFAULT_TIER_SLOS)
        loaded = load_slos(path)
        assert loaded == DEFAULT_TIER_SLOS


class TestSLOTracker:
    def test_attainment_and_goodput_accounting(self):
        tr = SLOTracker({0: SLOSpec("gold", ttft_ms=50.0), 1: SLOSpec("bulk")})
        met = _req(ttft=0.01, tier=0, tenant="a", rid=0)
        blew = _req(ttft=0.2, tier=0, tenant="b", rid=1)
        bulk = _req(ttft=5.0, tier=1, tenant="c", rid=2)
        for m in (met, blew, bulk):
            tr.lifecycle("submit", m)
            tr.lifecycle("finish", m)
        rep = tr.report()
        t0 = rep["tiers"][0]
        assert (t0["finished"], t0["met"], t0["breached"]) == (2, 1, 1)
        assert t0["attainment"] == 0.5
        assert t0["breaches_by_target"] == {"ttft_ms": 1}
        assert rep["tiers"][1]["attainment"] == 1.0   # no targets = met
        assert rep["tenants"]["b"]["breached"] == 1
        assert rep["overall"]["finished"] == 3
        # goodput counts only SLO-met tokens
        assert rep["overall"]["tokens_met"] == \
            met.n_tokens + bulk.n_tokens
        assert tr.last_breach["request_id"] == 1
        assert tr.last_breach["violations"] == ["ttft_ms"]

    def test_shed_and_failure_split_by_cause(self):
        tr = SLOTracker()
        cases = [("rejected", "over_capacity", "shed_capacity_429"),
                 ("rejected", "timeout", "shed_deadline"),
                 ("failed", "request_error", "failed")]
        for i, (status, reason, _) in enumerate(cases):
            m = _req(ttft=None, tier=0, tenant="t", status=status,
                     reason=reason, rid=i)
            tr.lifecycle("submit", m)
            tr.lifecycle("reject", m)
        row = tr.report()["tiers"][0]
        assert row["shed_capacity_429"] == 1
        assert row["shed_deadline"] == 1
        assert row["failed"] == 1
        assert row["finished"] == 0 and row["attainment"] is None
        assert row["submitted"] == 3

    def test_untiered_requests_use_default_spec(self):
        tr = SLOTracker({}, default_spec=SLOSpec("any", ttft_ms=1.0))
        m = _req(ttft=0.5, tier=9, rid=0)
        tr.lifecycle("finish", m)
        assert tr.report()["tiers"][9]["breached"] == 1

    def test_registers_as_observer_and_snapshot_scope(self, model):
        params, cfg = model
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=1, batch_slots=2,
                           cache_len=32, slo=DEFAULT_TIER_SLOS)
        assert gw.slo in gw.metrics.observers
        gw.submit(PROMPTS[0], max_new_tokens=3, tenant="acme", tier=0)
        gw.run()
        snap = gw.snapshot()
        assert snap["slo"]["overall"]["finished"] == 1
        assert snap["slo"]["tenants"]["acme"]["finished"] == 1
        dash = reporting.slo_dashboard(gw.slo.report())
        assert "acme" in dash and "interactive" in dash
        json.dumps(snap, allow_nan=False)


# -------------------------------------------------------- flight recorder

def _load_dump(path):
    with open(path) as f:
        doc = json.load(f)
    _assert_trace_schema(doc["traceEvents"])
    return doc


class TestFlightRecorder:
    def test_slo_breach_dump_holds_the_evidence(self, model, tmp_path):
        """Force a breach (ttft bar of ~0) and assert the dump is a
        schema-valid Perfetto trace containing the offending request's
        spans, its lifecycle instants, and the trigger marker."""
        params, cfg = model
        slo = SLOTracker({0: SLOSpec("impossible", ttft_ms=1e-6)})
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=1, batch_slots=2,
                           cache_len=32, slo=slo,
                           flight=FlightRecorder(tmp_path, slo=slo))
        h = gw.submit(PROMPTS[0], max_new_tokens=3, tenant="acme", tier=0)
        gw.run()
        assert h.done
        assert gw.flight.trigger_counts.get("slo_breach", 0) >= 1
        assert gw.flight.dumps, "breach fired but nothing was dumped"
        doc = _load_dump(gw.flight.dumps[0])
        assert doc["otherData"]["trigger"] == "slo_breach"
        names = [e["name"] for e in doc["traceEvents"]]
        assert f"req{h.gid}" in names                 # the offending spans
        assert "TRIGGER:slo_breach" in names
        finishes = [e for e in doc["traceEvents"]
                    if e["ph"] == "i" and e["name"] == "finish"]
        assert any(e["args"]["request_id"] == h.gid and
                   e["args"]["tenant"] == "acme" for e in finishes)
        gw.flight.disarm()

    def test_illegal_transition_dump(self, model, tmp_path):
        params, cfg = model
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=1, batch_slots=2,
                           cache_len=32, flight=FlightRecorder(tmp_path))
        h = gw.submit(PROMPTS[1], max_new_tokens=2)
        gw.run()
        gw.metrics.finish(h.gid)              # double-finish: always a bug
        assert gw.metrics.illegal_transitions == 1
        assert gw.flight.trigger_counts == {"illegal_transition": 1}
        doc = _load_dump(gw.flight.dumps[0])
        assert doc["otherData"]["trigger"] == "illegal_transition"
        illegal = [e for e in doc["traceEvents"]
                   if e["ph"] == "i" and e["name"] == "illegal"]
        assert illegal and illegal[0]["args"]["request_id"] == h.gid
        gw.flight.disarm()

    def test_shed_spike_trigger_and_window_rearm(self, tmp_path):
        rec = FlightRecorder(tmp_path, shed_spike=(3, 60.0)).arm()
        gm = GatewayMetrics(total_slots=2)
        gm.observers.append(rec)
        for i in range(5):
            gm.submit(i, 4)
            gm.reject(i, reason="timeout")
        # 3 sheds fire the spike; the window re-arms, 2 more do not
        assert rec.trigger_counts == {"shed_spike": 1}
        doc = _load_dump(rec.dumps[0])
        assert doc["otherData"]["sheds_in_window"] == 3
        rec.disarm()

    def test_replica_failure_dump(self, tmp_path):
        rec = FlightRecorder(tmp_path).arm()
        rec.note_replica_failure(1, "RuntimeError('boom')")
        assert rec.trigger_counts == {"replica_failure": 1}
        doc = _load_dump(rec.dumps[0])
        fails = [e for e in doc["traceEvents"]
                 if e["name"] == "replica_failure"]
        assert fails and fails[0]["args"]["error"] == "RuntimeError('boom')"
        rec.disarm()

    def test_max_dumps_cap_counts_suppressed(self, tmp_path):
        rec = FlightRecorder(tmp_path, max_dumps=1).arm()
        assert rec.trigger("exception", error="first") is not None
        assert rec.trigger("exception", error="second") is None
        assert rec.trigger_counts == {"exception": 2}
        assert rec.suppressed == 1
        assert len(list(tmp_path.glob("flightrec-*.json"))) == 1
        s = rec.stats()
        assert s["dumps"] == 1 and s["suppressed"] == 1
        rec.disarm()

    def test_composes_with_explicit_tracer(self, tmp_path):
        """--trace + --flight-recorder: the recorder must not install a
        second tracer, and disarm must leave the explicit one running."""
        tr = otrace.enable()
        rec = FlightRecorder(tmp_path).arm()
        assert otrace.active() is tr
        rec.trigger("exception", error="x")
        rec.disarm()
        assert otrace.active() is tr          # not torn down by disarm
        otrace.disable()

    def test_arm_owns_tracer_when_none_active(self, tmp_path):
        assert otrace.active() is None
        rec = FlightRecorder(tmp_path).arm()
        assert otrace.active() is not None
        rec.disarm()
        assert otrace.active() is None


# ---------------------------------------------- gateway tenant threading

class TestTenantThreading:
    def test_tags_reach_metrics_and_trace(self, model):
        params, cfg = model
        tr = otrace.enable()
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=1, batch_slots=2,
                           cache_len=32)
        h = gw.submit(PROMPTS[0], max_new_tokens=3, tenant="initech-api",
                      tier=1)
        gw.run()
        m = gw.metrics.requests[h.gid]
        assert (m.tenant, m.tier) == ("initech-api", 1)
        events = otrace.disable().events()
        req = [e for e in events if e["ph"] == "X"
               and e["name"] == f"req{h.gid}"]
        assert req and req[0]["args"]["tenant"] == "initech-api"
        assert req[0]["args"]["tier"] == 1

    def test_journal_adoption_preserves_attribution(self, model, tmp_path):
        """Tenant/tier ride the durable payload: a journaled request
        adopted by a fresh gateway keeps its attribution, so the SLO
        report after crash recovery still bills the right tenant."""
        params, cfg = model
        journal = os.path.join(tmp_path, "slo.journal")
        gw1 = Gateway.build(params, cfg, device="cpu",
                            replicas=1, batch_slots=2,
                            cache_len=32, journal_path=journal)
        gw1.submit(PROMPTS[0], max_new_tokens=3, tenant="umbrella-api",
                   tier=1)
        gw1.queue.close()                     # "crash" before any step
        gw2 = Gateway.build(params, cfg, device="cpu",
                            replicas=1, batch_slots=2,
                            cache_len=32, journal_path=journal,
                            slo=DEFAULT_TIER_SLOS)
        done = gw2.run()
        assert len(done) == 1
        m = gw2.metrics.requests[done[0].gid]
        assert (m.tenant, m.tier) == ("umbrella-api", 1)
        rep = gw2.slo.report()
        assert rep["tenants"]["umbrella-api"]["finished"] == 1
        assert rep["tenants"]["umbrella-api"]["tier"] == 1

    def test_capacity_429_lands_as_shed_capacity(self, model):
        params, cfg = model
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=1, batch_slots=2,
                           cache_len=32, admit_budget=8,
                           slo=DEFAULT_TIER_SLOS)
        h = gw.submit(PROMPTS[0], max_new_tokens=32, tenant="hooli-batch",
                      tier=2)                 # demand 40 > budget 8
        gw.run()
        assert h.metrics.status == "rejected"
        assert h.metrics.finish_reason == "over_capacity"
        assert gw.slo.report()["tiers"][2]["shed_capacity_429"] == 1

    def test_replay_drives_workload_to_completion(self, model, tmp_path):
        """End-to-end: generated trace -> paced replay through a gateway
        with the full stack armed -> every request served, per-tenant SLO
        rows populated, zero spurious flight dumps, warnings clean."""
        params, cfg = model
        spec = _spec(duration_s=0.4, base_rate_rps=25.0)
        reqs = owl.generate(spec)
        assert reqs
        slo = SLOTracker(DEFAULT_TIER_SLOS)
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=2, batch_slots=2,
                           cache_len=32, policy="least-loaded", slo=slo,
                           flight=FlightRecorder(tmp_path, slo=slo))
        handles = owl.replay(gw, reqs, time_scale=0.1)
        assert len(handles) == len(reqs)
        assert all(h.done for h in handles)
        rep = slo.report()
        assert rep["overall"]["finished"] == len(reqs)
        served_tenants = {r.tenant for r in reqs}
        assert set(rep["tenants"]) == served_tenants
        assert not gw.flight.dumps, \
            f"spurious flight dumps: {gw.flight.dumps}"
        gw.flight.disarm()
        snap = gw.snapshot()
        assert {"gateway", "slo", "flight"} <= set(snap)
        json.dumps(snap, allow_nan=False)


# --------------------------------------------------- parity, stack armed

@pytest.mark.parametrize("path", sorted(PATHS))
def test_parity_with_full_obs_stack(model, path, tmp_path):
    """The whole observability stack — tenant tags, live SLO judgment,
    armed flight recorder — must be a pure observer: not one token may
    differ from a plain gateway on any decode path."""
    params, cfg = model
    kw = dict(PATHS[path])
    if kw.get("kv_layout") == "paged":
        kw["block_size"] = 4

    def drive(armed: bool):
        extra = {}
        if armed:
            slo = SLOTracker(DEFAULT_TIER_SLOS)
            extra = dict(slo=slo,
                         flight=FlightRecorder(tmp_path / path, slo=slo))
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=1, batch_slots=2,
                           cache_len=32, **kw, **extra)
        tags = dict(tenant="acme-chat", tier=0) if armed else {}
        reqs = [gw.submit(p, max_new_tokens=3 + 2 * i, **tags)
                for i, p in enumerate(PROMPTS)]
        gw.run()
        for r in reqs:
            assert r.done and r.error is None
        if armed:
            rep = gw.slo.report()
            assert rep["overall"]["finished"] == len(PROMPTS)
            gw.flight.disarm()
        return [r.output for r in reqs]

    baseline = drive(armed=False)
    assert drive(armed=True) == baseline, \
        f"obs stack changed tokens on {path}"
