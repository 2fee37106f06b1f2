"""The port's copy of tests/test_timeseries.py, case for case:
repro_torch's tiny-config engines on the CPU (seeded torch weights,
`device="cpu"`). The reference's docstring follows.

Continuous telemetry: snapshot flattening, the ring-buffered sampler,
its gateway wiring (sampler scope, pressure gauges, flight-recorder
counter tracks), lock-order auditing of the armed pipeline, and the
sparkline/worker-health rendering in `reporting`."""
import json
import math
import threading
import time

import pytest
import torch

from _torch_host import one_torch_thread, shut_down_gateways  # noqa: F401
from repro_torch.concurrency import audit_serving_stack
from repro_torch.concurrency.locks import AuditedLock
from repro_torch.configs.base import ModelConfig
from repro_torch.core import reporting
from repro_torch.gateway.gateway import BrownoutConfig, Gateway
from repro_torch.models import transformer as T
from repro_torch.obs import trace as otrace
from repro_torch.obs.timeseries import TimeSeriesSampler, flatten_numeric

from test_torch_obs import _assert_trace_schema

V = 41
PROMPTS = [[3, 1, 4, 1], [5, 9, 2], [6, 5, 3, 5], [8, 9, 7]]


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


# ------------------------------------------------------------- flattening

class TestFlatten:
    def test_nested_dicts_and_lists(self):
        flat = flatten_numeric({"a": {"b": 1, "c": [2.5, 3]}, "d": 4})
        assert flat == {"a.b": 1.0, "a.c.0": 2.5, "a.c.1": 3.0, "d": 4.0}

    def test_bools_are_01_strings_and_none_skipped(self):
        flat = flatten_numeric({"on": True, "off": False, "name": "x",
                                "gone": None})
        assert flat == {"on": 1.0, "off": 0.0}

    def test_non_finite_skipped(self):
        flat = flatten_numeric({"ok": 1.0, "bad": float("nan"),
                                "inf": math.inf})
        assert flat == {"ok": 1.0}


# ---------------------------------------------------------------- sampler

class TestSampler:
    def test_rings_bounded_and_ordered(self):
        src = {"x": 0}
        s = TimeSeriesSampler(lambda: src, interval_s=0.01, capacity=4)
        for i in range(10):
            src["x"] = i
            s.sample_now()
        pts = s.series("x")
        assert len(pts) == 4                    # retention bound
        assert [v for _, v in pts] == [6.0, 7.0, 8.0, 9.0]
        ts = [t for t, _ in pts]
        assert ts == sorted(ts)

    def test_window_aggregates_and_counter_rate(self):
        vals = iter(range(0, 50, 5))
        s = TimeSeriesSampler(lambda: {"c": next(vals)}, interval_s=0.01,
                              capacity=64)
        for _ in range(10):
            s.sample_now()
        w = s.window("c")
        assert w["n"] == 10 and w["last"] == 45.0
        assert w["min"] == 0.0 and w["max"] == 45.0
        assert w["mean"] == pytest.approx(22.5)
        assert w["p95"] == 45.0
        # first-to-last slope: 45 over the window's wall span
        pts = s.series("c")
        span = pts[-1][0] - pts[0][0]
        assert w["rate_per_s"] == pytest.approx(45.0 / span)
        assert s.window("missing") is None

    def test_recent_prefix_and_trailing_window(self):
        s = TimeSeriesSampler(lambda: {"a": {"x": 1}, "b": {"x": 2}},
                              interval_s=0.01, capacity=64)
        s.sample_now()
        time.sleep(0.03)
        s.sample_now()
        rec = s.recent(prefix="a.")
        assert list(rec) == ["a.x"] and len(rec["a.x"]) == 2
        tiny = s.recent(0.001)
        assert all(len(pts) == 1 for pts in tiny.values())

    def test_source_errors_counted_not_fatal(self):
        calls = {"n": 0}

        def src():
            calls["n"] += 1
            if calls["n"] % 2:
                raise RuntimeError("flaky scope")
            return {"x": calls["n"]}

        s = TimeSeriesSampler(src, interval_s=0.01)
        for _ in range(4):
            s.sample_now()
        assert s.sample_errors == 2 and s.samples == 2
        assert [v for _, v in s.series("x")] == [2.0, 4.0]

    def test_thread_lifecycle_and_cadence(self):
        s = TimeSeriesSampler(lambda: {"x": 1}, interval_s=0.005)
        with s:
            assert s.running
            deadline = time.monotonic() + 2.0
            while s.samples < 3 and time.monotonic() < deadline:
                time.sleep(0.005)
        assert not s.running
        assert s.samples >= 3
        assert s.stats()["n_series"] == 1

    def test_jsonl_export_roundtrip(self, tmp_path):
        s = TimeSeriesSampler(lambda: {"a": 1, "b": {"c": 2}},
                              interval_s=0.01)
        s.sample_now()
        s.sample_now()
        path = s.export_jsonl(tmp_path / "series.jsonl")
        lines = path.read_text().splitlines()
        docs = [json.loads(ln) for ln in lines]
        assert [d["name"] for d in docs] == ["a", "b.c"]
        assert all(len(d["points"]) == 2 for d in docs)
        assert all(v == 1.0 for _, v in docs[0]["points"])
        # the HTTP /series.jsonl body is the same serialization
        assert s.to_jsonl() == path.read_text()

    def test_validation(self):
        with pytest.raises(ValueError):
            TimeSeriesSampler(dict, interval_s=0)
        with pytest.raises(ValueError):
            TimeSeriesSampler(dict, capacity=1)


# -------------------------------------------------------- gateway wiring

def test_gateway_sampler_scope_and_series(model):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=32)
    s = gw.start_sampler(interval_s=0.005)
    assert gw.start_sampler() is s              # idempotent
    for p in PROMPTS[:2]:
        gw.submit(p, max_new_tokens=3)
    gw.run()
    s.sample_now()
    names = s.names()
    assert "gateway.completed" in names
    assert "gateway.queue_depth" in names       # instantaneous summary keys
    assert "gateway.active_slots" in names
    assert "sampler.samples" in names           # the sampler observes itself
    assert s.series("gateway.completed")[-1][1] == 2.0
    snap = gw.snapshot()
    assert snap["sampler"]["n_series"] == len(names)
    gw.shutdown()                               # stops the sampler thread
    assert not s.running


def test_pressure_gauges_show_ladder_transitions(model):
    """S6: brownout level and shed-by-cause are sampled as gauges every
    gateway step, so the series shows *when* the ladder moved and which
    valve opened — not just end-of-run cumulative counters."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=1, cache_len=32,
                       kv_layout="paged", block_size=4,
                       brownout=BrownoutConfig(depth_high=1,
                                               escalate_steps=1,
                                               cool_steps=50,
                                               shed_tier_min=2))
    s = gw.start_sampler(interval_s=0.002)
    prem = [gw.submit(p, max_new_tokens=3, tier=0) for p in PROMPTS * 2]
    batch = [gw.submit(p, max_new_tokens=3, tier=2, tenant="batchco")
             for p in PROMPTS]
    gw.run()
    s.sample_now()
    assert all(r.done for r in prem)
    shed = [b for b in batch if b.status == "rejected"]
    assert shed, "pressure never shed the batch tier"
    # the per-step gauges reached the series
    level = [v for _, v in s.series("pressure.brownout_level")]
    assert max(level) >= 1, "ladder transition never sampled"
    sheds = [v for _, v in s.series("pressure.shed_brownout")]
    assert sheds and sheds[-1] == float(len(shed))
    # and the same gauges ride the snapshot for the exposition endpoint
    flat = flatten_numeric(gw.snapshot())
    assert flat["pressure.shed_brownout"] == float(len(shed))
    assert gw.metrics.reject_reason_counts() == {"brownout": len(shed)}
    gw.shutdown()


def test_flight_dump_carries_counter_tracks(model, tmp_path):
    """An armed sampler rides every flight-recorder dump as Perfetto
    ``ph="C"`` counter events: the post-mortem shows queue depth and the
    pressure gauges leading up to the anomaly, alongside the spans."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=32,
                       flight=str(tmp_path))
    s = gw.start_sampler(interval_s=0.005)
    assert gw.flight.sampler is s               # armed-by-wiring
    for p in PROMPTS[:2]:
        gw.submit(p, max_new_tokens=3)
    gw.run()
    s.sample_now()
    path = gw.flight.trigger("manual_probe")
    gw.shutdown()
    doc = json.loads(path.read_text())
    _assert_trace_schema(doc["traceEvents"])
    counters = [e for e in doc["traceEvents"] if e["ph"] == "C"]
    assert counters, "no counter tracks in the dump"
    names = {e["name"] for e in counters}
    assert "gateway.queue_depth" in names
    assert "gateway.active_slots" in names
    assert all("value" in e["args"] for e in counters)


def test_audit_covers_sampler_and_ledger_locks(model):
    """The armed telemetry pipeline stays inside the audited lock
    hierarchy: sampler and ledger are leaves, and a full run with the
    auditor wrapping every lock ends clean."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=32,
                       kv_layout="paged", block_size=4)
    gw.arm_ledger()
    s = gw.start_sampler(interval_s=0.002)
    s.stop()                                    # swap locks parked
    aud = audit_serving_stack(gw)
    assert isinstance(gw.sampler._mu, AuditedLock)
    assert isinstance(gw.ledger._mu, AuditedLock)
    s.start()
    reqs = [gw.submit(p, max_new_tokens=4, tenant=f"t{i % 2}", tier=i % 2)
            for i, p in enumerate(PROMPTS)]
    gw.run()
    s.sample_now()
    gw.shutdown()
    assert all(r.done for r in reqs)
    aud.assert_clean()
    # the telemetry locks are leaves: they never appear as a *source* of
    # an ordering edge (nothing is acquired while they are held)
    edges = aud.edges()
    assert "sampler" not in edges and "ledger" not in edges


def test_sampler_lock_is_leaf_under_concurrent_readers(model):
    """Exporter-shaped readers hammer the rings while the sampler thread
    appends: no deadlock, no RuntimeError from mutation-during-iteration
    (the queries copy under the leaf lock)."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=32)
    s = gw.start_sampler(interval_s=0.001)
    errs = []

    def reader():
        try:
            for _ in range(200):
                for n in s.names():
                    s.window(n, 1.0)
                s.recent(0.5)
                s.to_jsonl()
        except Exception as e:          # noqa: BLE001 — recorded for assert
            errs.append(e)

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    for p in PROMPTS:
        gw.submit(p, max_new_tokens=3)
    gw.run()
    for t in threads:
        t.join(timeout=30)
    gw.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert not errs


# ------------------------------------------------------------- rendering

class TestRendering:
    def test_sparkline_resamples_and_scales(self):
        assert reporting.sparkline([]) == ""
        line = reporting.sparkline([0, 0, 0, 7], width=4)
        assert len(line) == 4 and line[0] == "▁" and line[-1] == "█"
        # longer inputs bucket-mean down to width
        assert len(reporting.sparkline(list(range(100)), width=10)) == 10
        # pinned scale: half-range value renders mid-glyph, not max
        pinned = reporting.sparkline([5], lo=0, hi=10)
        assert pinned not in ("▁", "█")
        # flat series with default scale stays low, never crashes on /0
        assert set(reporting.sparkline([3, 3, 3])) == {"▁"}

    def test_timeseries_panel(self):
        src = {"gateway": {"queue_depth": 0, "active_slots": 0}}
        s = TimeSeriesSampler(lambda: src, interval_s=0.01)
        assert reporting.timeseries_panel(s) == ""      # no points: silent
        for i in range(6):
            src["gateway"]["queue_depth"] = i
            src["gateway"]["active_slots"] = i % 2
            s.sample_now()
        panel = reporting.timeseries_panel(s)
        assert "gateway.queue_depth" in panel
        assert "gateway.active_slots" in panel
        assert "last=" in panel and "max=5" in panel
        named = reporting.timeseries_panel(s, names=["gateway.queue_depth"])
        assert "active_slots" not in named

    def test_worker_health_table(self):
        ws = {"n_workers": 2, "alive": 1, "pumps": 10, "engine_steps": 7,
              "pump_errors": 1,
              "per_worker": [
                  {"replica": 0, "alive": True, "pumps": 6,
                   "engine_steps": 5, "pump_errors": 0},
                  {"replica": 1, "alive": False, "pumps": 4,
                   "engine_steps": 2, "pump_errors": 1}]}
        table = reporting.worker_health_table(ws)
        assert "replica0" in table and "replica1" in table
        assert "NO" in table                    # the dead worker stands out
        assert "1/2" in table                   # fleet roll-up row

    def test_unified_dashboard_gains_telemetry_sections(self, model):
        params, cfg = model
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=1, batch_slots=2,
                           cache_len=32, kv_layout="paged", block_size=4)
        gw.arm_ledger()
        s = gw.start_sampler(interval_s=0.005)
        gw.submit(PROMPTS[0], max_new_tokens=3, tenant="acme", tier=1)
        gw.run()
        s.sample_now()
        dash = reporting.unified_dashboard(gw.snapshot(), gw.metrics.gauges)
        gw.shutdown()
        assert "utilization ledger" in dash
        assert "acme" in dash
        assert "telemetry sampler" in dash
        # no NaN cell ever renders ("tenant" itself contains "nan", so
        # match the word, not the substring)
        import re
        assert not re.search(r"\bnan\b", dash.lower())
