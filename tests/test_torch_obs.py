"""The port's copy of tests/test_obs.py, case for case:
repro_torch's tiny-config engines on the CPU (seeded torch weights,
`device="cpu"`). The reference's docstring follows.

Observability subsystem: tracer, registry, and their serving wiring.

Covers the obs primitives (ring-buffered span tracer, fixed-bucket
histograms, the unified metrics registry), the Chrome-trace export
contract (schema-valid events, consistent nesting, every finished request
covered submit -> retire), the tracing *parity* contract (recording spans
must not change a single token on any decode path), the strict
request-lifecycle state machine, and the None-not-NaN empty-series
percentile fix.
"""
import json
import math

import pytest
import torch

from _torch_host import one_torch_thread, shut_down_gateways  # noqa: F401
from repro_torch.configs.base import ModelConfig
from repro_torch.core import reporting
from repro_torch.gateway.gateway import Gateway
from repro_torch.gateway.metrics import GatewayMetrics, percentile
from repro_torch.models import transformer as T
from repro_torch.obs import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs import trace as otrace
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sampler import SamplingParams

V = 41

PROMPTS = [[3, 1, 4, 3, 1, 4, 3, 1], [3, 1, 4, 3, 7], [9, 10, 11, 12],
           [5, 5, 5, 5, 5, 5]]

# every decode path of the parity matrix, greedy row: tracing must be a
# pure observer on each of them
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


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    """Tracing is process-global: never let one test's tracer leak."""
    otrace.disable()
    yield
    otrace.disable()


# ---------------------------------------------------------------- registry

class TestInstruments:
    def test_counter_monotonic(self):
        c = Counter()
        c.inc()
        c.inc(4)
        assert c.value == 5
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_gauge_last_write_wins(self):
        g = Gauge()
        g.set(3)
        g.set(1.5)
        assert g.value == 1.5

    def test_histogram_percentiles_bucket_resolution(self):
        h = Histogram(buckets=(1.0, 10.0, 100.0))
        for v in (0.5, 0.7, 5.0, 50.0):
            h.observe(v)
        assert h.n == 4
        # p50 lands in the first bucket -> its upper bound
        assert h.percentile(50) == 1.0
        # the top percentile is clamped to the exact observed max
        assert h.percentile(100) == 50.0
        assert h.vmin == 0.5 and h.vmax == 50.0

    def test_histogram_overflow_bucket(self):
        h = Histogram(buckets=(1.0,))
        h.observe(999.0)
        assert h.counts[-1] == 1
        assert h.percentile(50) == 999.0     # clamped to vmax

    def test_histogram_empty(self):
        h = Histogram()
        assert h.percentile(50) is None
        assert h.summary()["count"] == 0
        assert h.summary()["mean"] is None

    def test_histogram_merge_exact(self):
        a, b = Histogram(buckets=(1.0, 10.0)), Histogram(buckets=(1.0, 10.0))
        for v in (0.5, 5.0):
            a.observe(v)
        for v in (0.2, 20.0):
            b.observe(v)
        m = a.merge(b)
        assert m.n == 4
        assert m.counts == [a.counts[i] + b.counts[i] for i in range(3)]
        assert m.vmin == 0.2 and m.vmax == 20.0
        with pytest.raises(ValueError):
            a.merge(Histogram(buckets=(2.0,)))

    def test_histogram_rejects_bad_buckets(self):
        with pytest.raises(ValueError):
            Histogram(buckets=())
        with pytest.raises(ValueError):
            Histogram(buckets=(2.0, 1.0))

    def test_registry_get_or_create_and_type_clash(self):
        r = MetricsRegistry()
        assert r.counter("a.hits") is r.counter("a.hits")
        with pytest.raises(TypeError):
            r.gauge("a.hits")

    def test_registry_snapshot_scopes_and_instruments(self):
        r = MetricsRegistry()
        r.counter("engine.steps").inc(3)
        r.histogram("engine.lat_ms").observe(2.0)
        r.register_scope("gateway", lambda: {"completed": 7})
        r.register_scope("off_feature", lambda: None)
        snap = r.snapshot()
        assert snap["gateway"] == {"completed": 7}
        assert "off_feature" not in snap
        assert snap["engine"]["steps"] == 3
        assert snap["engine"]["lat_ms_count"] == 1
        assert snap["engine"]["lat_ms_max"] == 2.0


# ------------------------------------------------------------------ tracer

class TestTracer:
    def test_disabled_is_noop_singleton(self):
        assert not otrace.enabled()
        s = otrace.span("x")
        assert s is otrace.span("y")        # shared null object
        with s:
            pass
        otrace.add_span("x", 0.0, 1.0)      # no-op, no error

    def test_span_recording_and_args(self):
        tr = otrace.enable(capacity=16)
        with otrace.span("work", cat="test", tid=3, items=2):
            pass
        assert tr.recorded == 1 and len(tr) == 1
        ev = [e for e in tr.events() if e["ph"] == "X"]
        assert ev[0]["name"] == "work" and ev[0]["tid"] == 3
        assert ev[0]["args"] == {"items": 2}
        assert ev[0]["dur"] >= 0

    def test_ring_bounds_and_drop_count(self):
        tr = otrace.enable(capacity=4)
        for i in range(10):
            with otrace.span(f"s{i}"):
                pass
        assert len(tr) == 4 and tr.recorded == 10 and tr.dropped == 6
        names = [e["name"] for e in tr.events() if e["ph"] == "X"]
        assert names == ["s6", "s7", "s8", "s9"]    # oldest evicted

    def test_stats_feed_snapshot_scope(self):
        tr = otrace.enable(capacity=8)
        with otrace.span("a"):
            pass
        st = tr.stats()
        assert st == {"enabled": True, "capacity": 8, "spans_recorded": 1,
                      "spans_buffered": 1, "spans_dropped": 0}

    def test_export_is_valid_chrome_trace(self, tmp_path):
        tr = otrace.enable()
        tr.set_track_name(otrace.HOST_PID, 0, "replica0")
        with otrace.span("outer"):
            with otrace.span("inner"):
                pass
        path = tr.export(tmp_path / "t.json")
        doc = json.loads(path.read_text())
        assert set(doc) == {"traceEvents", "displayTimeUnit"}
        _assert_trace_schema(doc["traceEvents"])

    def test_fence_is_identity(self):
        x = {"a": 1}
        assert otrace.fence(x) is x         # disabled: not even a walk
        otrace.enable()
        y = {"t": [torch.ones(3)]}          # CPU tensors: nothing to wait on
        assert otrace.fence(y) is y

    def test_capacity_validation(self):
        with pytest.raises(ValueError):
            otrace.enable(capacity=0)


def _assert_trace_schema(events):
    """The Chrome-trace contract the exporter promises: required fields
    per phase (complete "X" spans, "M" metadata, the flight recorder's
    "i" instants and "C" counter tracks), and begin/end consistency —
    spans sharing a track either nest fully or are disjoint (the code is
    single-threaded per track, so a partial overlap means a broken
    timestamp)."""
    assert events, "empty trace"
    by_track = {}
    for e in events:
        assert e["ph"] in ("X", "M", "i", "C"), e
        assert {"ph", "name", "pid", "tid", "ts"} <= set(e), e
        if e["ph"] == "M":
            assert e["name"] in ("process_name", "thread_name")
            assert "name" in e["args"]
            continue
        if e["ph"] == "i":
            # instant events carry a scope instead of a duration
            assert e["s"] in ("g", "p", "t"), e
            continue
        if e["ph"] == "C":
            # counter events (sampler series in flight dumps) carry a value
            assert "value" in e["args"], e
            continue
        assert "dur" in e and e["dur"] >= 0 and e["ts"] >= 0
        assert "cat" in e
        by_track.setdefault((e["pid"], e["tid"]), []).append(e)
    eps = 0.5   # us: tolerate float rounding at shared boundaries
    for track, evs in by_track.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and stack[-1] <= e["ts"] + eps:
                stack.pop()
            end = e["ts"] + e["dur"]
            assert not stack or end <= stack[-1] + eps, \
                f"partially overlapping spans on track {track}: {e}"
            stack.append(end)


# --------------------------------------------------- parity + engine wiring

@pytest.mark.parametrize("path", sorted(PATHS))
def test_tracing_parity_and_step_spans(model, path):
    """Greedy row of the decode-path parity matrix, tracing as the
    variable: span recording must not change one token, and every path
    must leave engine.step spans tagged with its step type."""
    params, cfg = model
    kw = dict(PATHS[path])
    if kw.get("kv_layout") == "paged":
        kw["block_size"] = 4

    def drive():
        eng = ServeEngine(params, cfg, device="cpu",
                          batch_slots=2, cache_len=32, **kw)
        reqs = [eng.submit(p, max_new_tokens=3 + 2 * i)
                for i, p in enumerate(PROMPTS)]
        eng.run()
        for r in reqs:
            assert r.error is None and r.done
        return [r.output for r in reqs], eng

    baseline, _ = drive()
    tr = otrace.enable()
    traced, eng = drive()
    otrace.disable()
    assert traced == baseline, f"tracing changed tokens on {path}"
    steps = [e for e in tr.events()
             if e["ph"] == "X" and e["name"] == "engine.step"]
    assert steps, f"no engine.step spans on {path}"
    kinds = {e["args"]["step"] for e in steps}
    expect = {"fused": "fused", "speculative": "spec",
              "chunked": "mixed"}.get(path, "decode")
    assert expect in kinds, f"{path}: step kinds {kinds}"
    # the always-on step-latency histograms saw the same step types
    assert eng.step_summary() is not None
    assert expect in eng.step_summary()
    _assert_trace_schema(tr.events())


def test_gateway_trace_covers_every_finished_request(model, tmp_path):
    params, cfg = model
    tr = otrace.enable()
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=32,
                       kv_layout="paged", block_size=4)
    reqs = [gw.submit(p, max_new_tokens=4) for p in PROMPTS]
    gw.run()
    events = tr.events()
    _assert_trace_schema(events)
    xs = [e for e in events if e["ph"] == "X"]
    names = {e["name"] for e in xs}
    assert {"gateway.submit", "gateway.dispatch", "engine.step",
            "engine.retire"} <= names
    for r in reqs:
        assert r.done
        req_spans = [e for e in xs if e["name"] == f"req{r.gid}"]
        assert len(req_spans) == 1, f"req{r.gid} not covered"
        span = req_spans[0]
        assert span["pid"] == otrace.REQUEST_PID and span["tid"] == r.gid
        assert span["args"]["status"] == "done"
        assert span["args"]["tokens"] == len(r.output)
        phases = [e["name"] for e in xs
                  if e["pid"] == otrace.REQUEST_PID and e["tid"] == r.gid
                  and e is not span]
        assert sorted(phases) == ["queued", "running"]
    # export round-trips
    doc = json.loads(otrace.disable().export(tmp_path / "g.json").read_text())
    assert len(doc["traceEvents"]) == len(events)


def test_unified_snapshot_and_dashboard(model):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=32,
                       kv_layout="paged", block_size=4, scheduler="chunked",
                       chunk_budget=3)
    for p in PROMPTS[:2]:
        gw.submit(p, max_new_tokens=3)
    gw.run()
    snap = gw.snapshot()
    # one coherent dict over every silo
    assert snap["gateway"]["completed"] == 2
    assert snap["gateway"] == gw.summary()
    assert snap["kvcache"] == gw.kvcache_summary()
    assert snap["scheduler"] == gw.scheduler_summary()
    assert "speculation" not in snap        # feature off -> scope omitted
    assert "trace" not in snap              # tracing off -> scope omitted
    steps = snap["engine_steps"]
    assert steps["mixed_count"] > 0 and steps["mixed_p95"] > 0
    dash = reporting.unified_dashboard(snap, gw.metrics.gauges)
    for needle in ("gateway summary", "chunked-prefill scheduler",
                   "prefill_tokens_chunked", "queue depth", "active slots",
                   "engine step latency", "kv cache"):
        assert needle in dash, f"dashboard lost {needle!r}"
    assert "nan" not in dash.lower()
    # with tracing on, the tracer scope appears
    otrace.enable()
    assert gw.snapshot()["trace"]["enabled"] is True


def test_engine_step_summary_merges_replicas(model):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=1, cache_len=32)
    for p in PROMPTS:
        gw.submit(p, max_new_tokens=2)
    gw.run()
    merged = gw.engine_step_summary()
    per_replica = [r.engine.step_times["decode"].n for r in gw.replicas]
    assert all(n > 0 for n in per_replica), "a replica never stepped"
    assert merged["decode_count"] == sum(per_replica)


# ------------------------------------------------- strict lifecycle states

class TestRequestLifecycle:
    def test_legal_chain(self):
        gm = GatewayMetrics()
        gm.submit(0, 3)
        gm.dispatch(0, replica_id=1)
        gm.finish(0)
        assert gm.requests[0].status == "done"
        assert gm.completed == 1 and gm.illegal_transitions == 0

    def test_double_finish_refused_and_counted(self):
        gm = GatewayMetrics()
        gm.submit(0, 3)
        gm.dispatch(0, replica_id=0)
        gm.finish(0)
        gm.finish(0)                        # lifecycle bug: logged, refused
        assert gm.completed == 1            # aggregate not double-counted
        assert gm.illegal_transitions == 1
        assert gm.requests[0].status == "done"

    def test_terminal_states_have_no_exits(self):
        gm = GatewayMetrics()
        gm.submit(0, 3)
        gm.reject(0)
        gm.dispatch(0, replica_id=0)        # rejected -> running: illegal
        assert gm.requests[0].status == "rejected"
        assert gm.dispatched == 0 and gm.illegal_transitions == 1
        assert gm.requests[0].dispatch_t is None   # side effects skipped

    def test_requeue_only_from_running(self):
        gm = GatewayMetrics()
        gm.submit(0, 3)
        gm.requeue(0)                       # queued -> queued: illegal
        assert gm.illegal_transitions == 1
        gm.dispatch(0, replica_id=0)
        gm.requeue(0)                       # running -> queued: legal
        assert gm.requests[0].status == "queued"
        assert gm.illegal_transitions == 1

    def test_unknown_state_asserts(self):
        gm = GatewayMetrics()
        gm.submit(0, 3)
        with pytest.raises(AssertionError):
            gm.reject(0, status="exploded")


# --------------------------------------------------- None-not-NaN percentile

class TestEmptySeries:
    def test_percentile_empty_is_none(self):
        assert percentile([], 50) is None
        assert percentile([2.0], 50) == 2.0

    def test_summary_no_nan_with_zero_requests(self):
        s = GatewayMetrics().summary()
        assert s["ttft_p50_ms"] is None
        assert s["itl_max_ms"] is None
        assert s["stall_p95_ms"] is None
        for v in s.values():
            assert not (isinstance(v, float) and math.isnan(v)), s
        # and it serializes: None -> null, never the invalid-JSON NaN
        json.dumps(s, allow_nan=False)

    def test_dashboard_renders_em_dash(self):
        s = GatewayMetrics().summary()
        table = reporting.gateway_summary_table(s)
        assert "—" in table
        assert "nan" not in table.lower() and "None" not in table

    def test_sampled_request_metrics_flow(self, model):
        """End-to-end: a run whose requests all get rejected produces a
        None-bearing, dash-rendering summary, not NaN."""
        params, cfg = model
        gw = Gateway.build(params, cfg, device="cpu",
                           batch_slots=2, cache_len=32,
                           admit_budget=4)
        r = gw.submit(list(range(10)), max_new_tokens=20)   # over budget
        assert r.status == "rejected"
        s = gw.summary()
        assert s["rejected"] == 1 and s["ttft_p50_ms"] is None
        assert "—" in reporting.unified_dashboard(gw.snapshot())


# ------------------------------------------ partial scopes + tiny series

class TestPartialScopeMerges:
    """Cross-replica registry merges when a replica contributes nothing:
    a fleet where one replica never stepped (all work landed elsewhere,
    or it was failed before its first step) must aggregate cleanly from
    the replicas that did."""

    def test_merge_with_idle_replica(self, model):
        params, cfg = model
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=2, batch_slots=2,
                           cache_len=32)
        gw.submit(PROMPTS[0], max_new_tokens=3)
        gw.run()
        stepped = [r for r in gw.replicas if r.engine.step_times]
        idle = [r for r in gw.replicas if not r.engine.step_times]
        assert stepped and idle, "expected one active and one idle replica"
        merged = gw.engine_step_summary()
        assert merged["decode_count"] == \
            stepped[0].engine.step_times["decode"].n
        json.dumps(gw.snapshot(), allow_nan=False)      # and no NaN leaks

    def test_merge_with_replica_failed_before_first_step(self, model):
        params, cfg = model
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=2, batch_slots=2,
                           cache_len=32)
        gw.replicas[1].healthy = False      # down before any dispatch
        for p in PROMPTS[:2]:
            gw.submit(p, max_new_tokens=2)
        done = gw.run()
        assert len(done) == 2
        merged = gw.engine_step_summary()
        assert merged["decode_count"] == \
            gw.replicas[0].engine.step_times["decode"].n
        assert not gw.replicas[1].engine.step_times

    def test_kvcache_scope_skips_dense_replicas(self, model):
        """A mixed fleet: the kvcache scope aggregates only the replicas
        that have a paged cache (provider None for the dense one)."""
        params, cfg = model
        engines = [ServeEngine(params, cfg, device="cpu",
                               batch_slots=2, cache_len=32),
                   ServeEngine(params, cfg, device="cpu",
                               batch_slots=2, cache_len=32,
                               kv_layout="paged", block_size=4)]
        gw = Gateway(engines, policy="round-robin")
        for p in PROMPTS[:2]:
            gw.submit(p, max_new_tokens=2)
        gw.run()
        kv = gw.kvcache_summary()
        assert kv is not None
        assert kv == gw.replicas[1].engine.cache_metrics.as_dict()

    def test_single_observation_histogram_percentiles(self):
        h = Histogram()
        h.observe(7.5)
        assert h.percentile(50) == 7.5
        assert h.percentile(95) == 7.5
        assert h.percentile(100) == 7.5
        s = h.summary()
        assert s["count"] == 1
        assert s["p50"] == s["p95"] == s["max"] == 7.5

    def test_single_request_gateway_percentiles(self, model):
        """One finished request: every percentile is the one sample, and
        nothing renders as NaN."""
        params, cfg = model
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=1, batch_slots=2,
                           cache_len=32)
        gw.submit(PROMPTS[0], max_new_tokens=3)
        gw.run()
        s = gw.summary()
        assert s["ttft_p50_ms"] == s["ttft_p99_ms"]
        assert s["stall_p50_ms"] == s["stall_max_ms"]
        json.dumps(s, allow_nan=False)


def test_sampled_parity_with_tracing(model):
    """Seeded sampling row: tracing must not disturb the host PRNG
    stream either."""
    params, cfg = model
    sp = SamplingParams(temperature=0.8, seed=11)

    def drive():
        eng = ServeEngine(params, cfg, device="cpu",
                          batch_slots=2, cache_len=32)
        reqs = [eng.submit(p, max_new_tokens=4, sampling=sp)
                for p in PROMPTS[:2]]
        eng.run()
        return [r.output for r in reqs]

    base = drive()
    otrace.enable()
    assert drive() == base
