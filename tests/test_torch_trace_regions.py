"""Device time by region (`repro_torch.obs.trace`): `region`, the step
timers and the spans that carry their readings, on the CPU.

On the CPU ops are synchronous, so a region's time is `perf_counter`
stamps, and the fused body runs eagerly with the same regions as the
graph's capture. Covered: every step kind's `engine.step` span carries
`device` with the model's region names, the regions' sum within the
covered time; tracing off makes no timer, region or dict; the new host
spans nest (`gateway.step` around `engine.step`, `engine.reconcile`
around `engine.retire`); every program span and eager region is mirrored
as a `torch.profiler` range, which the benchmark's profile reducer does
not take for its own labels; the gateway's `graph` snapshot scope. The
card's graph capture: `tests/test_torch_gateway_cuda.py`.
"""
import sys
from pathlib import Path

import pytest
import torch

from _torch_host import one_torch_thread, shut_down_gateways  # noqa: F401
from repro_torch.configs import registry
from repro_torch.core import reporting
from repro_torch.gateway.gateway import Gateway
from repro_torch.models import transformer as T
from repro_torch.obs import trace as otrace
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9],
           [2, 7, 1, 8, 2, 8]]
ATTN = {"attn.proj", "attn.core", "logits"}
REGIONS = {"granite-moe-1b-a400m": ATTN | {"moe.route", "moe.dispatch",
                                           "moe.experts", "moe.combine"},
           "qwen3-1.7b": ATTN | {"ffn"}}
NOT_REGIONS = ("total_ms", "covered_ms")


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    otrace.disable()
    yield
    otrace.disable()


@pytest.fixture
def every_step(monkeypatch):
    """Every eager step timed, not one in `EAGER_TIMING_EVERY`."""
    monkeypatch.setattr(engine_mod, "EAGER_TIMING_EVERY", 1)


@pytest.fixture(scope="module", params=sorted(REGIONS))
def model(request):
    cfg = registry.get(request.param, reduced=True)
    return request.param, T.init_lm(torch.Generator().manual_seed(0), cfg), \
        cfg


def _engine(params, cfg, **kw):
    return ServeEngine(params, cfg, device="cpu", batch_slots=2,
                       cache_len=64, kv_layout="paged", block_size=16,
                       prefill_mode="bulk", fused_tokens=4, **kw)


def _serve(eng):
    reqs = [eng.submit(p, max_new_tokens=6 + i)
            for i, p in enumerate(PROMPTS)]
    eng.run()
    assert all(r.done and r.error is None for r in reqs)
    return [r.output for r in reqs]


def _regions(d):
    return {k: v for k, v in d.items() if k not in NOT_REGIONS}


def test_step_spans_carry_device_regions(model, every_step):
    """Prefill, fused and single steps each carry `device`: the model's
    regions, every one positive, their sum within the covered time, the
    covered time within the step's total; tokens as untraced."""
    arch, params, cfg = model
    want = _serve(_engine(params, cfg))
    tr = otrace.enable()
    got = _serve(_engine(params, cfg))
    otrace.disable()
    assert got == want
    steps = [s for s in tr._ring if s.name == "engine.step"]
    kinds = {s.args["step"] for s in steps}
    assert {"prefill", "fused", "decode"} <= kinds
    for s in steps:
        d = s.args["device"]
        regions = _regions(d)
        assert set(regions) == REGIONS[arch], (s.args["step"], d)
        assert all(v > 0 for v in regions.values()), d
        covered = d.get("covered_ms", d["total_ms"])
        assert ("covered_ms" in d) == (s.args["step"] == "fused")
        assert sum(regions.values()) <= covered <= d["total_ms"]
        assert d["total_ms"] <= 1e3 * s.dur
        # the arguments the span had before stay as they were
        assert {"step", "live"} <= set(s.args) or \
            {"step", "prompt_len", "reused"} <= set(s.args)


def test_fused_step_times_its_first_step_only(model, monkeypatch,
                                              every_step):
    """The fused body's later steps run muted: a fused step's timer holds
    one `attn.core` segment a layer (a single step takes the same), and
    one covered stretch."""
    _, params, cfg = model
    counts = []
    read = otrace.StepTimer.read

    def counting(self):
        names = [name for name, _, _ in self.regions]
        counts.append((names.count("covered_ms"), names.count("attn.core")))
        return read(self)
    monkeypatch.setattr(otrace.StepTimer, "read", counting)
    tr = otrace.enable()
    _serve(_engine(params, cfg))
    otrace.disable()
    kinds = [s.args["step"] for s in tr._ring if s.name == "engine.step"]
    assert len(kinds) == len(counts) and "fused" in kinds
    for kind, (covered, core) in zip(kinds, counts):
        assert covered == (kind == "fused")
        assert core == cfg.n_layers, kind


def test_eager_steps_timed_one_in_four_fused_every_time(model):
    """Prefills and single decode steps (host-bound, eager) carry `device`
    one time in `EAGER_TIMING_EVERY`, counted on their thread from its
    first; fused dispatches every time."""
    _, params, cfg = model
    assert engine_mod.EAGER_TIMING_EVERY == 4
    otrace._LOCAL.sampled = 0
    tr = otrace.enable()
    eng = _engine(params, cfg)
    for i in range(3):
        for p in PROMPTS:
            eng.submit(p, max_new_tokens=5 + i)
    eng.run()
    otrace.disable()
    steps = [s for s in tr._ring if s.name == "engine.step"]
    eager = [s for s in steps if s.args["step"] != "fused"]
    assert len(eager) > 8
    assert [i for i, s in enumerate(eager) if "device" in s.args] == \
        list(range(0, len(eager), 4))
    assert all("device" in s.args for s in steps
               if s.args["step"] == "fused")


def test_tracing_off_makes_no_timer_region_or_dict(monkeypatch):
    assert not otrace.enabled()
    null = otrace.span("x")
    assert otrace.region("attn.core") is null
    assert otrace.cover(True) is null and otrace.cover(False) is null
    assert otrace.device_timer("cpu") is null
    assert otrace.step_timer() is None
    otrace.stop_timer()
    with otrace.region("ffn") as rg:
        rg.switch("logits")
    null.add_args(device={})

    def refuse(*a, **k):
        raise AssertionError("made while tracing is off")
    monkeypatch.setattr(otrace.StepTimer, "__init__", refuse)
    monkeypatch.setattr(otrace._Region, "__init__", refuse)
    monkeypatch.setattr(otrace._Mute, "__enter__", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(otrace.Tracer, "_record", refuse)
    cfg = registry.get("granite-moe-1b-a400m", reduced=True)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    _serve(_engine(params, cfg))


def test_regions_need_a_timed_step():
    """Tracing on, but no step timer on this thread: regions are the
    no-op; a timer's regions are its own thread's."""
    otrace.enable()
    null = otrace._NULL
    assert otrace.region("ffn") is null
    timer = otrace.device_timer("cpu")
    with otrace.region("ffn") as rg:
        rg.switch("logits")
    with otrace.cover(False):
        assert otrace.region("ffn") is null
    with otrace.cover(True):
        with otrace.region("attn.core"):
            pass
    with otrace.span("engine.step") as span:
        timer.attach(span)
    assert otrace.step_timer() is None
    d = otrace.active()._ring[-1].args["device"]
    assert set(d) == {"total_ms", "ffn", "logits", "covered_ms", "attn.core"}
    assert d["covered_ms"] >= d["attn.core"]


def test_graph_capture_sets_the_step_timer_aside():
    otrace.enable()
    timer = otrace.device_timer("cpu")
    with otrace.GraphCapture() as cap:
        assert otrace.step_timer() is None
        assert otrace.region("ffn") is otrace._NULL
    assert otrace.step_timer() is timer and cap.regions == []


def test_replayed_graph_gives_the_total_and_its_regions():
    """A step that replays a graph reads the replay's time as its total
    and the graph's regions as its own (clock marks stand in for the
    graph's events)."""
    otrace.enable()
    timer = otrace.device_timer("cpu")
    graph_regions = [("covered_ms", 1.0, 1.004), ("attn.core", 1.001,
                                                  1.003)]
    timer.replayed(graph_regions, 0.999, 1.010)
    d = timer.read()
    assert d["total_ms"] == pytest.approx(11.0)
    assert d["covered_ms"] == pytest.approx(4.0)
    assert d["attn.core"] == pytest.approx(2.0)


def _within(inner, outer):
    return outer.t0 <= inner.t0 and \
        inner.t0 + inner.dur <= outer.t0 + outer.dur


def test_gateway_step_and_reconcile_nest():
    cfg = registry.get("qwen3-1.7b", reduced=True)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    tr = otrace.enable()
    gw = Gateway.build(params, cfg, device="cpu", replicas=1,
                       batch_slots=2, cache_len=64, kv_layout="paged",
                       block_size=16, prefill_mode="bulk", fused_tokens=4)
    for i, p in enumerate(PROMPTS):
        gw.submit(p, max_new_tokens=6 + i)
    gw.run()
    spans = list(tr._ring)
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    for s in by["engine.step"]:
        assert any(_within(s, g) for g in by["gateway.step"]), s.args
    recon = by["engine.reconcile"]
    assert {r.args["step"] for r in recon} == {"fused", "decode"}
    in_recon = [r for r in by["engine.retire"]
                if any(_within(r, c) for c in recon)]
    assert in_recon
    for r in by["engine.retire"]:
        assert r in in_recon or any(
            _within(r, s) for s in by["engine.step"]
            if s.args["step"] == "prefill")
    for c in recon:
        assert any(_within(c, s) for s in by["engine.step"]
                   if s.args["step"] == c.args["step"])


def test_spans_mirror_into_the_profiler_not_its_labels():
    """Under a CPU `torch.profiler`, each program span and eager region is
    a `record_function` range of its name; the benchmark's reducer keeps
    only its own `portbench.` ranges as labels."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from portbench import profile as pbprofile
    cfg = registry.get("granite-moe-1b-a400m", reduced=True)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    gw = Gateway.build(params, cfg, device="cpu", replicas=1,
                       batch_slots=2, cache_len=64, kv_layout="paged",
                       block_size=16, prefill_mode="bulk", fused_tokens=4)
    tr = otrace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(pbprofile.WINDOW_LABEL):
            for i, p in enumerate(PROMPTS):
                gw.submit(p, max_new_tokens=6 + i)
            gw.run()
    otrace.disable()
    spans = {s.name for s in tr._ring if s.pid == otrace.HOST_PID}
    assert {"gateway.step", "engine.step", "engine.reconcile",
            "engine.retire", "gateway.dispatch"} <= spans
    ranges = {e.name() for e in prof.profiler.kineto_results.events()}
    assert spans <= ranges, spans - ranges
    assert REGIONS["granite-moe-1b-a400m"] <= ranges
    labels = {n for n, _, _ in pbprofile.reduce(prof)["labels"]}
    assert not labels & (spans | REGIONS["granite-moe-1b-a400m"])


def test_spans_not_mirrored_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: calls.append(name))
    otrace.enable()
    timer = otrace.device_timer("cpu")
    with otrace.span("engine.step") as span:
        with otrace.region("ffn"):
            pass
        timer.attach(span)
    assert calls == []


def test_graph_scope_in_snapshot_and_dashboard():
    cfg = registry.get("qwen3-1.7b", reduced=True)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    gw = Gateway.build(params, cfg, device="cpu", replicas=2,
                       batch_slots=2, cache_len=64, kv_layout="paged",
                       block_size=16, fused_tokens=4)
    for r, n in zip(gw.replicas, (1, 2)):
        g = r.engine._decode_fused
        g.captures, g.replays, g.warmup_runs = n, 10 * n, 2 * n
    snap = gw.snapshot()
    assert snap["graph"] == {"captures": 3, "replays": 30, "warmup_runs": 6}
    assert "engine_steps" not in snap        # no step yet
    dash = reporting.unified_dashboard(snap)
    assert "fused decode graph" in dash and "captures" in dash
    plain = Gateway.build(params, cfg, device="cpu", replicas=1,
                          batch_slots=2, cache_len=64, kv_layout="paged",
                          block_size=16)
    assert "graph" not in plain.snapshot()


def test_engine_track_reaches_its_graph():
    cfg = registry.get("qwen3-1.7b", reduced=True)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    gw = Gateway.build(params, cfg, device="cpu", replicas=2,
                       batch_slots=2, cache_len=64, kv_layout="paged",
                       block_size=16, fused_tokens=4)
    assert [r.engine._decode_fused.trace_tid for r in gw.replicas] == [0, 1]


def test_capture_counters_hold_under_threads(monkeypatch):
    """Captures on many threads at once: the armed flag and the garbage
    collector's pause are counted under locks, so when every thread is
    done the tracer is disarmed and the collector is on again."""
    import gc
    import threading
    from repro_torch.serve import graph as graph_mod
    monkeypatch.setattr(gc, "collect", lambda *a: 0)
    assert gc.isenabled()
    errors = []

    def work():
        try:
            for _ in range(200):
                with otrace.GraphCapture() as cap, cap.recording(), \
                        graph_mod._collector_paused():
                    assert otrace._ARMED and not gc.isenabled()
        except BaseException as err:     # re-raised on the main thread
            errors.append(err)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert not otrace._ARMED and otrace._CAPTURES == 0
    assert graph_mod._GC_PAUSES == 0 and gc.isenabled()
