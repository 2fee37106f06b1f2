"""The port's copy of tests/test_async_workers.py, case for case:
repro_torch's tiny-config engines on the CPU (seeded torch weights,
`device="cpu"`). The reference's docstring follows.

Async replica workers: sync/async token parity on every decode path,
seeded deterministic-interleaving replay through the concurrency harness,
worker-thread supervision, lock-order/race auditing of the live stack, and
an exactly-once stress test with concurrent submitters + worker death."""
import threading
import time

import pytest
import torch

from _torch_host import one_torch_thread, shut_down_gateways  # noqa: F401
from repro_torch.chaos import FaultInjector, parse_plan
from repro_torch.concurrency import (ExclusiveRegion, LockOrderAuditor,
                                     StepBarrierScheduler, audit_serving_stack)
from repro_torch.configs.base import ModelConfig
from repro_torch.gateway.gateway import Gateway
from repro_torch.gateway.workers import WorkerDied
from repro_torch.models import transformer as T
from repro_torch.obs import trace as otrace
from repro_torch.serve.engine import ServeEngine

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


def _productive(trace):
    """Grant log truncated at the last engine-step grant: everything
    after it is idle pumping whose count depends on how fast the main
    thread noticed completion (wall clock), not on the seed."""
    last = max((i for i, (_, lbl) in enumerate(trace) if lbl == "step"),
               default=-1)
    return trace[:last + 1]


# ------------------------------------------------------- sync/async parity

@pytest.mark.parametrize("path", sorted(PATHS))
def test_async_parity_across_decode_paths(model, path):
    """Token streams must be byte-identical between the synchronous
    lockstep gateway and the async worker fleet, on every decode path."""
    params, cfg = model
    kw = dict(PATHS[path])
    if kw.get("kv_layout") == "paged":
        kw["block_size"] = 4
    outs = {}
    for mode in ("sync", "async"):
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=2, batch_slots=2,
                           cache_len=32, async_workers=(mode == "async"),
                           **kw)
        reqs = [gw.submit(p, max_new_tokens=8) for p in PROMPTS]
        gw.run()
        gw.shutdown()
        assert all(r.done for r in reqs), \
            [(r.status, r.stream.finish_reason) for r in reqs]
        outs[mode] = [r.output for r in reqs]
    assert outs["sync"] == outs["async"]


# ------------------------------------------- seeded deterministic replay

def _gated_run(model, seed, *, plan=None, max_new=4):
    """One async run under the step-barrier scheduler; returns the token
    streams, per-stream restart counts, and the productive grant trace."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=64,
                       max_retries=5, poison_threshold=0)
    inj = FaultInjector(parse_plan(plan, seed=0)).arm(gw) if plan else None
    sched = StepBarrierScheduler(seed, ["w0", "w1"], stall_timeout_s=60.0)
    reqs = [gw.submit(p, max_new_tokens=max_new) for p in PROMPTS]
    gw.start_workers({0: sched.gate("w0"), 1: sched.gate("w1")})
    gw.run()
    gw.shutdown()
    sched.finish_all()
    if inj is not None:
        inj.disarm()
    assert all(r.done for r in reqs)
    return ([r.output for r in reqs],
            [r.stream.restarts for r in reqs],
            _productive(sched.trace))


def test_seeded_replay_is_byte_identical(model, oracle):
    """Two consecutive runs of the same seed replay the exact same
    interleaving (grant-for-grant) and the exact same token streams; a
    different seed schedules differently but still decodes correctly."""
    out1, _, tr1 = _gated_run(model, seed=7)
    out2, _, tr2 = _gated_run(model, seed=7)
    out3, _, tr3 = _gated_run(model, seed=11)
    assert tr1 == tr2
    assert out1 == out2 == out3 == oracle
    assert tr1 != tr3


def test_seed_sweep_explores_interleavings_with_parity(model, oracle):
    """Distinct seeds produce distinct adversarial schedules; the decoded
    streams must match the oracle under every one of them."""
    traces = set()
    for seed in (0, 1, 2, 3):
        out, _, tr = _gated_run(model, seed=seed)
        assert out == oracle, f"seed {seed} corrupted the token streams"
        traces.add(tuple(tr))
    assert len(traces) > 1, "seed sweep collapsed to one schedule"


def test_seeded_replay_with_crash_fault(model, oracle):
    """Crash + requeue under the deterministic scheduler: the fault fires
    on the replica's own dispatch clock, so the whole recovery — failure,
    stream restart, re-dispatch to the survivor — replays identically."""
    plan = "crash@d2:r0"
    out1, rs1, tr1 = _gated_run(model, seed=5, plan=plan)
    out2, rs2, tr2 = _gated_run(model, seed=5, plan=plan)
    assert tr1 == tr2
    assert rs1 == rs2
    assert sum(rs1) >= 1, "crash never forced a stream restart"
    assert out1 == out2 == oracle


# ------------------------------------------------- supervision + lifecycle

def test_worker_death_is_supervised(model, oracle):
    """A worker thread that dies uncleanly is a crash fault on its
    replica: the consumer pump notices, fails the replica (leases nack
    back), respawns a worker, and probation reintegrates the replica —
    with every stream still delivered exactly once."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=64,
                       async_workers=True, probation_seconds=0.05,
                       max_retries=5, poison_threshold=0)
    reqs = [gw.submit(p, max_new_tokens=4) for p in PROMPTS]
    gw._ensure_workers()
    victim = gw._workers[0]
    time.sleep(0.02)
    victim.kill()
    gw.run()
    stats = gw.worker_stats()
    gw.shutdown()
    rep0 = gw.replicas[0]
    assert rep0.failures >= 1
    assert "WorkerDied" in (rep0.last_error or "") or rep0.reintegrations >= 1
    assert all(w["alive"] for w in stats)       # respawned fleet served on
    assert [r.output for r in reqs] == oracle


def test_worker_died_is_a_runtime_error():
    assert issubclass(WorkerDied, RuntimeError)


def test_shutdown_idempotent_and_context_manager(model):
    params, cfg = model
    with Gateway.build(params, cfg, device="cpu", replicas=2, batch_slots=2,
                       cache_len=64, async_workers=True) as gw:
        r = gw.submit(PROMPTS[0], max_new_tokens=3)
        gw.run()
        assert r.done
        gw.shutdown()
        gw.shutdown()               # second call is a no-op
    assert gw._workers == []


def test_start_workers_twice_rejected(model):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=64)
    gw.start_workers()
    try:
        with pytest.raises(RuntimeError, match="already started"):
            gw.start_workers()
    finally:
        gw.shutdown()


def test_pool_pressure_fault_rejected_in_async_mode(model):
    """The pool fault mutates an engine's BlockPool from the consumer
    thread — racy against the owner worker, so arming it on an async
    gateway must fail loudly instead of corrupting the run."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=32,
                       kv_layout="paged", block_size=4, async_workers=True)
    inj = FaultInjector(parse_plan("pool@s2-8:r0:4", seed=0))
    with pytest.raises(ValueError, match="pool_pressure"):
        inj.arm(gw)
    gw.shutdown()


# --------------------------------------------------- lock/race auditing

def test_serving_stack_lock_order_clean_under_load(model, oracle):
    """Run the async fleet with the whole lock hierarchy wrapped by the
    auditor and every engine step inside an ExclusiveRegion: a lock-order
    cycle or a second thread stepping someone else's engine fails the
    test, crash fault and all."""
    params, cfg = model
    otrace.enable()
    try:
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=2, batch_slots=2,
                           cache_len=64, async_workers=True,
                           probation_seconds=0.05, max_retries=5,
                           poison_threshold=0)
        auditor = audit_serving_stack(gw)
        assert isinstance(auditor, LockOrderAuditor)
        regions = []
        for rep in gw.replicas:
            reg = ExclusiveRegion(f"engine{rep.replica_id}.step")
            orig = rep.engine.step

            def stepped(orig=orig, reg=reg):
                with reg:
                    return orig()

            rep.engine.step = stepped
            regions.append(reg)
        with FaultInjector(parse_plan("crash@d2:r0", seed=0)).arm(gw):
            reqs = [gw.submit(p, max_new_tokens=4) for p in PROMPTS]
            gw.run()
        gw.shutdown()
        assert [r.output for r in reqs] == oracle
        auditor.assert_clean()
        for reg in regions:
            reg.assert_clean()
            assert reg.entries > 0
        edges = auditor.edges()
        assert "queue" in edges.get("gateway", set())
    finally:
        otrace.disable()


# --------------------------------------------------------- stress test

def test_stress_concurrent_submit_worker_death_requeue(model):
    """The full adversarial mix at once: two submitter threads racing the
    fleet, a chaos crash on each replica's own dispatch clock, and a
    worker thread killed mid-run. Every stream must be visible exactly
    once (the on_token callback sees precisely the final output — the
    TokenStream.restart() replay cursor swallows re-decoded prefixes),
    and the queue must end drained with zero leases."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=64,
                       async_workers=True, probation_seconds=0.05,
                       max_retries=8, poison_threshold=0)
    inj = FaultInjector(parse_plan("crash@d3:r0,crash@d9:r1", seed=0)).arm(gw)
    handles = []
    visible = {}
    mu = threading.Lock()

    def submitter():
        for p in PROMPTS:
            seen = []
            r = gw.submit(list(p), max_new_tokens=4,
                          on_token=seen.append)
            with mu:
                handles.append(r)
                visible[r.gid] = seen
            time.sleep(0.002)

    subs = [threading.Thread(target=submitter) for _ in range(2)]
    for t in subs:
        t.start()
    gw._ensure_workers()
    time.sleep(0.01)
    gw._workers[1].kill()           # thread death != engine crash
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        gw.step()
        with mu:
            settled = (len(handles) == 2 * len(PROMPTS)
                       and all(r.finished for r in handles))
        if settled and not any(t.is_alive() for t in subs):
            break
    for t in subs:
        t.join(timeout=10)
    gw.run()
    gw.shutdown()
    inj.disarm()
    # replica 0's crash fires on its own dispatch clock; replica 1's may
    # not (its worker is killed, and the fleet can drain before it rejoins)
    assert inj.count("crash") >= 1
    assert len(handles) == 2 * len(PROMPTS)
    assert all(r.done for r in handles), \
        [(r.status, r.stream.finish_reason) for r in handles]
    # exactly-once visibility: what the callback streamed is exactly the
    # final output, even for requests that crashed and re-decoded
    for r in handles:
        assert visible[r.gid] == r.output, \
            (f"gid {r.gid}: visible {visible[r.gid]} != output {r.output} "
             f"(restarts={r.stream.restarts})")
    assert sum(r.stream.restarts for r in handles) >= 1
    # per-prompt determinism: both submitters' copies decoded identically
    by_prompt = {}
    for r in handles:
        by_prompt.setdefault(tuple(r.prompt), []).append(r.output)
    for prompt, outs in by_prompt.items():
        assert outs[0] == outs[1], f"prompt {prompt} diverged: {outs}"
    st = gw.queue.stats()
    assert st["pending"] == 0 and st["leased"] == 0 and st["dead"] == 0


# ------------------------------------------- worker telemetry (S1 + S2)

def test_workers_scope_in_snapshot_and_dashboard(model):
    """Worker health reaches the unified snapshot as a `workers` scope
    (omitted while no fleet exists) and renders as the worker-health
    table in the dashboard."""
    from repro_torch.core import reporting
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=32,
                       async_workers=True)
    assert "workers" not in gw.snapshot()       # no fleet yet
    reqs = [gw.submit(p, max_new_tokens=3) for p in PROMPTS]
    gw.run()
    snap = gw.snapshot()
    ws = snap["workers"]
    assert ws["n_workers"] == 2 and ws["alive"] == 2
    assert ws["engine_steps"] > 0 and ws["pumps"] > 0
    assert [w["replica"] for w in ws["per_worker"]] == [0, 1]
    dash = reporting.unified_dashboard(snap)
    assert "worker fleet" in dash and "replica0" in dash and "2/2" in dash
    gw.shutdown()
    assert all(r.done for r in reqs)


def test_worker_tracks_named_when_tracing_enabled_late(model):
    """The common serve order is build the fleet, then arm observability.
    Worker threads announce their per-replica track name once, at thread
    start; a tracer enabled *after* `start_workers` must still carry the
    thread_name metadata, and every async-mode engine span must land on
    a named per-replica track in the Perfetto export."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=32)
    gw.start_workers()
    # wait until every worker thread has pumped (its announce line ran)
    deadline = time.monotonic() + 5.0
    while not all(s["pumps"] > 0 for s in gw.worker_stats()) \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    tr = otrace.enable()
    try:
        reqs = [gw.submit(p, max_new_tokens=4) for p in PROMPTS]
        gw.run()
        gw.shutdown()
        assert all(r.done for r in reqs)
        events = tr.events()
        meta = {(e["pid"], e["tid"]): e["args"]["name"] for e in events
                if e["ph"] == "M" and e["name"] == "thread_name"}
        for rid in (0, 1):
            assert meta.get((otrace.HOST_PID, rid)) == f"replica{rid}", \
                f"replica{rid} track unnamed: late enable lost the announce"
        steps = [e for e in events
                 if e["ph"] == "X" and e["name"] == "engine.step"]
        assert steps
        for e in steps:
            assert meta.get((e["pid"], e["tid"]), "").startswith("replica"), \
                f"engine.step span on anonymous track {(e['pid'], e['tid'])}"
    finally:
        otrace.disable()
