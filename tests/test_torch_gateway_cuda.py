"""Two replicas on one card, each stepped on a thread of its own, as the
gateway's async workers step them: one replica captures its fused decode
graph while the other steps eagerly, or both capture at once. The tokens
must be those of the serial runs, every fused graph must have recorded
only its own thread's paged-kernel calls, and `paged_attention.launches`
must be exact. Then the async gateway itself, with a crash: the crashed
replica resets and captures its graph again while the other one replays.

Reduced qwen3-1.7b (2 layers, d 256, 4/2 heads, hd 64) in f32 with TF32
off and the port's seeded weights. Skips cleanly where torch sees no CUDA
device. Imports no JAX. Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_gateway_cuda.py``.
"""
import threading

import pytest
import torch

from repro_torch.chaos import FaultInjector, parse_plan
from repro_torch.configs import registry
from repro_torch.gateway.gateway import Gateway
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import transformer as T
from repro_torch.obs import trace as otrace
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.gpu

BS, N = 16, 4
PROMPTS = [[3, 1, 4, 3, 1, 4, 3, 1], [3, 1, 4, 3, 7], [9, 10, 11, 12],
           [5, 5, 5, 5, 5, 5], [3, 1, 4, 3, 1, 4, 9, 9, 2]]
WAIT_S = 60.0


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph and the paged kernel "
                    "have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(device):
    cfg = registry.get("qwen3-1.7b", reduced=True)
    return T.init_lm(torch.Generator(device=device).manual_seed(0), cfg), cfg


def _engine(model, device, fused):
    params, cfg = model
    return ServeEngine(params, cfg, batch_slots=4, cache_len=64,
                       kv_layout="paged", block_size=BS,
                       fused_tokens=N if fused else 1, device=device)


def _serve(eng, prompts):
    reqs = [eng.submit(p, max_new_tokens=6 + 2 * i)
            for i, p in enumerate(prompts)]
    eng.run()
    assert all(r.done and r.error is None for r in reqs)
    return [r.output for r in reqs]


def _serial(model, device, kinds):
    """Tokens and paged-kernel launches of each engine run alone."""
    out = []
    for fused in kinds:
        pa_ops.paged_attention.launches = 0
        toks = _serve(_engine(model, device, fused), PROMPTS)
        torch.cuda.synchronize()
        out.append((toks, pa_ops.paged_attention.launches))
    return out


def _hold_capture(eng, capturing: threading.Event, release: threading.Event):
    """Make the engine's fused body, while it is being captured, announce
    that and wait until `release` is set: whatever another thread does in
    between happens during this capture."""
    graph = eng._decode_fused
    body = graph.body

    def held(*args):
        if torch.cuda.is_current_stream_capturing():
            capturing.set()
            assert release.wait(WAIT_S), "the other thread never released"
        return body(*args)
    graph.body = held


def _run_threads(*fns):
    errors = []

    def guard(fn):
        try:
            fn()
        except BaseException as err:     # re-raised on the main thread
            errors.append(err)
    threads = [threading.Thread(target=guard, args=(fn,)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"
    if errors:
        raise errors[0]


@pytest.mark.parametrize("tracing", [False, True], ids=["quiet", "traced"])
def test_capture_while_another_thread_steps_eagerly(device, model, tracing):
    """Replica A captures its fused graph; during the capture replica B
    admits, prefills and decodes eagerly (allocations, host copies, kernel
    launches; traced, each dispatch span also waits for B's stream). Neither
    disturbs the other."""
    (want_a, n_a), (want_b, n_b) = _serial(model, device, (True, False))
    a, b = _engine(model, device, True), _engine(model, device, False)
    capturing, b_stepped = threading.Event(), threading.Event()
    _hold_capture(a, capturing, b_stepped)
    got = {}

    def run_b():
        assert capturing.wait(WAIT_S), "A never started its capture"
        reqs = [b.submit(p, max_new_tokens=6 + 2 * i)
                for i, p in enumerate(PROMPTS)]
        b.step()
        b.step()
        b_stepped.set()
        b.run()
        got["b"] = [r.output for r in reqs]

    def run_a():
        got["a"] = _serve(a, PROMPTS)

    pa_ops.paged_attention.launches = 0
    if tracing:
        otrace.enable()
    try:
        _run_threads(run_a, run_b)
    finally:
        tracer = otrace.disable()
    torch.cuda.synchronize()
    if tracing:
        assert any(e["name"] == "device.fused" for e in tracer.events())
    assert got["a"] == want_a and got["b"] == want_b
    assert a._decode_fused._launches[pa_ops.paged_attention] == \
        model[1].n_layers * N
    assert pa_ops.paged_attention.launches == n_a + n_b


def test_two_captures_at_once(device, model):
    """Both replicas capture at the same time, each on its own stream: each
    graph records n_layers x N calls, its own, and the total is exact."""
    (want, n_one), = _serial(model, device, (True,))
    a, b = _engine(model, device, True), _engine(model, device, True)
    in_a, in_b = threading.Event(), threading.Event()
    _hold_capture(a, in_a, in_b)
    _hold_capture(b, in_b, in_a)
    got = {}

    def run(name, eng):
        return lambda: got.__setitem__(name, _serve(eng, PROMPTS))

    pa_ops.paged_attention.launches = 0
    _run_threads(run("a", a), run("b", b))
    torch.cuda.synchronize()
    assert got["a"] == want and got["b"] == want
    for eng in (a, b):
        assert eng._decode_fused._launches[pa_ops.paged_attention] == \
            model[1].n_layers * N
    assert pa_ops.paged_attention.launches == 2 * n_one


def test_async_gateway_crash_recaptures_while_the_peer_replays(device,
                                                               model):
    """Two async replicas with fused graphs; replica 0 crashes at its 3rd
    dispatch and rejoins at once (warm reset: new pools, the graph
    released). Tokens equal the synchronous gateway's, replica 0 captured
    twice, and the launches are n_layers x (N x (replays + warm-up runs)
    + single decode steps) over both replicas (bulk prefill: a decode-
    mode prefill would read through the kernel too)."""
    params, cfg = model
    kw = dict(replicas=2, batch_slots=2, cache_len=64, kv_layout="paged",
              block_size=BS, prefill_mode="bulk", fused_tokens=N,
              device=device)
    prompts = PROMPTS * 2

    def serve(gw):
        with gw:
            reqs = [gw.submit(p, max_new_tokens=8 + i % 5)
                    for i, p in enumerate(prompts)]
            gw.run()
        assert all(r.done for r in reqs)
        return [r.output for r in reqs]

    want = serve(Gateway.build(params, cfg, **kw))
    gw = Gateway.build(params, cfg, async_workers=True, probation_seconds=0,
                       **kw)
    inj = FaultInjector(parse_plan("crash@d2:r0")).arm(gw)
    pa_ops.paged_attention.launches = 0
    try:
        got = serve(gw)
    finally:
        inj.disarm()
    torch.cuda.synchronize()
    assert got == want
    assert inj.count("crash") == 1
    r0 = gw.replicas[0]
    assert r0.failures == 1 and r0.reintegrations == 1
    graphs = [r.engine._decode_fused for r in gw.replicas]
    assert [g.captures for g in graphs] == [2, 1]
    single = sum(r.engine.step_times["decode"].n
                 for r in gw.replicas if "decode" in r.engine.step_times)
    assert pa_ops.paged_attention.launches == cfg.n_layers * (
        N * sum(g.replays + g.warmup_runs for g in graphs) + single)


def test_graph_regions_read_after_traced_replays_only(device, model,
                                                      monkeypatch):
    """The timed fused graph's regions, captured as timing events, give
    positive times after a traced replay: the first decode step's
    (`covered_ms`), within the replay's device time. Untraced replays run
    the plain graph and read nothing. A capture after `reset()` is a
    `graph.capture` span and times its regions as the first did."""
    monkeypatch.setattr(engine_mod, "EAGER_TIMING_EVERY", 1)
    eng = _engine(model, device, True)
    reads = []
    elapsed = torch.cuda.Event.elapsed_time

    def counted(self, end):
        reads.append(1)
        return elapsed(self, end)
    monkeypatch.setattr(torch.cuda.Event, "elapsed_time", counted)
    want = _serve(eng, PROMPTS)
    assert eng._decode_fused.replays > 0 and reads == []
    names = {"attn.proj", "attn.core", "ffn", "logits"}
    for capture in (False, True):
        if capture:
            eng.reset()
        tr = otrace.enable()
        try:
            assert _serve(eng, PROMPTS) == want
        finally:
            otrace.disable()
        assert reads
        spans = list(tr._ring)
        assert sum(s.name == "graph.capture" for s in spans) == capture
        steps = [s for s in spans if s.name == "engine.step"]
        assert {"prefill", "fused"} <= {s.args["step"] for s in steps}
        for s in steps:
            d = s.args["device"]
            regions = {k: v for k, v in d.items()
                       if k not in ("total_ms", "covered_ms")}
            assert set(regions) == names and min(regions.values()) > 0, d
            covered = d.get("covered_ms", d["total_ms"])
            assert sum(regions.values()) <= 1.01 * covered, d
            assert 0 < covered <= d["total_ms"] <= 1e3 * s.dur, d
        reads.clear()
    assert eng._decode_fused.captures == 2
