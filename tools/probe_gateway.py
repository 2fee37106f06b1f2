#!/usr/bin/env python3
"""Probe where the gateway's time goes with replicas on one NVIDIA GPU:
measurements that chip_smoke.py does not repeat on every run.

    python3 tools/probe_gateway.py [--sections 1,2,3,4,5,6]

Full-width qwen3-1.7b in bf16 with chip_smoke.py's phase 3 weights and
requests made greedy, on the paged layout with chip_smoke.py's engine
settings (8 slots, 512-token chains of 16-token pages, bulk prefill).
Prints one line per measurement and, last, one JSON object.

1. The fused graph's capture (`FusedDecodeGraph._capture`: two eager
   warm-up runs of the 8-step body and the capture), at an engine's
   first fused dispatch: alone; while another thread spins in pure
   Python (holding the interpreter lock but no CUDA call); while a second
   engine steps single-token decodes on another thread.
2. Gateways of two replicas, synchronous and with async workers, at
   fused_tokens 1 and 8: a first round of the requests (graphs captured),
   then a timed round of the same requests. Wall time, tokens/s, time to
   first token and between tokens (p50, p95), engine steps by kind.
3. The async fused gateway again with the interpreter's thread switch
   interval at 0.1 ms (`sys.setswitchinterval`; the default is 5 ms).
4. A capture while another thread makes round trips to the card (one
   element copied to the host, in a loop): how many it made and the
   longest one, beside the same loop alone.
5. The timeline of chip_smoke.py's phase 19 scenario (async workers,
   fused graphs captured in a warm-up round, replica 0 crashing at its 3rd
   dispatch and rejoining, request 1 decoding `LONG_TOKENS`): every engine
   step, prefill, fused dispatch and capture of each replica on the host
   clock, in ms from the run's start.
6. One engine's capture held open (its body waits inside the capture)
   while a second engine, whose graph is already captured, runs fused
   dispatches on another thread: how many it completed while the capture
   was open, each one's ms split into the graph's replay call and the
   copy of its outputs to the host, and the same dispatches alone.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402  (model, requests, engine settings)

FUSED = 8


def engine(params, cfg, fused):
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(params, cfg, kv_layout="paged", prefill_mode="bulk",
                       batch_slots=8, cache_len=512, block_size=16,
                       fused_tokens=fused, device="cuda")


def timed_capture(eng) -> list:
    """Wrap the engine's graph capture to record its host-clock ms."""
    graph, out = eng._decode_fused, []
    capture = graph._capture

    def wrapper(*args):
        t0 = time.perf_counter()
        try:
            return capture(*args)
        finally:
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    graph._capture = wrapper
    return out


def capture_ms(params, cfg, requests, peer=None) -> float:
    """ms of one engine's first capture, with `peer` (a callable taking a
    stop event) running on another thread meanwhile."""
    eng = engine(params, cfg, FUSED)
    caps = timed_capture(eng)
    for p, _, n in requests[:8]:
        eng.submit(p, max_new_tokens=n)
    stop = threading.Event()
    thread = None
    if peer is not None:
        thread = threading.Thread(target=peer, args=(stop,))
        thread.start()
        time.sleep(0.2)
    try:
        while not caps:
            eng.step()
    finally:
        stop.set()
        if thread is not None:
            thread.join(60)
    return caps[0]


def spin(stop):
    x = 0
    while not stop.is_set():
        x += 1


def eager_peer(params, cfg, requests):
    def run(stop):
        eng = engine(params, cfg, 1)
        while not stop.is_set():
            for p, _, _ in requests[:8]:
                eng.submit(p, max_new_tokens=24)
            while eng.has_work() and not stop.is_set():
                eng.step()
            eng.reset()
    return run


def round_trips(stop, out):
    """One element to the host and back, in a loop until `stop`: count
    and the longest ms."""
    x = torch.ones(1, device="cuda")
    n, worst = 0, 0.0
    while not stop.is_set():
        t0 = time.perf_counter()
        x.add_(1).cpu()
        worst = max(worst, time.perf_counter() - t0)
        n += 1
    out.update(n=n, max_ms=worst * 1e3)


def trips_during_capture(params, cfg, requests) -> dict:
    alone = {}
    stop = threading.Event()
    timer = threading.Timer(1.0, stop.set)
    timer.start()
    round_trips(stop, alone)
    during = {}
    ms = capture_ms(params, cfg, requests,
                    lambda stop: round_trips(stop, during))
    return {"alone_1s": alone, "during_capture": during, "capture_ms": ms}


def timeline(params, cfg, requests) -> list:
    """chip_smoke.py phase 19's run with every replica's steps, prefills,
    fused dispatches and captures recorded: (replica, what, start ms, end
    ms) from the counted run's start."""
    from repro_torch.chaos import FaultInjector, parse_plan
    from repro_torch.gateway.gateway import Gateway
    gw = Gateway.build(params, cfg, replicas=2, batch_slots=8,
                       cache_len=512, kv_layout="paged", block_size=16,
                       prefill_mode="bulk", fused_tokens=FUSED,
                       async_workers=True,
                       probation_seconds=smoke.PROBATION_S,
                       retry_backoff_s=smoke.RETRY_BACKOFF_S, device="cuda")
    events = []

    def timed(fn, rid, what):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                events.append((rid, what, t0, time.perf_counter()))
        return wrapper
    smoke.warm_gateway(gw, cfg)
    for r in gw.replicas:
        eng, rid = r.engine, r.replica_id
        eng._decode_fused._capture = timed(eng._decode_fused._capture, rid,
                                           "capture")
        eng._step_fused = timed(eng._step_fused, rid, "fused")
        eng._prefill_slot = timed(eng._prefill_slot, rid, "prefill")
    inj = FaultInjector(parse_plan(smoke.CRASH_PLAN)).arm(gw)
    for r in gw.replicas:   # outermost: the chaos wrapper raises inside it
        r.engine.step = timed(r.engine.step, r.replica_id, "step")
    requests = list(requests)
    requests[1] = (requests[1][0], None, smoke.LONG_TOKENS)
    t0 = time.perf_counter()
    try:
        for p, _, n in requests:
            gw.submit(p, max_new_tokens=n)
        gw.run()
    finally:
        gw.shutdown()
        inj.disarm()
    return sorted((rid, what, round((a - t0) * 1e3, 1),
                   round((b - t0) * 1e3, 1)) for rid, what, a, b in events)


def replays_beside_open_capture(params, cfg, requests, hold_s=1.0) -> dict:
    """Section 6: engine B (graph captured) dispatches while engine A's
    capture is held open for `hold_s` seconds (at most 10 s, should B's
    dispatches wait for it), then as many alone."""
    a, b = engine(params, cfg, FUSED), engine(params, cfg, FUSED)
    for eng in (a, b):
        for p, _, _ in requests[:8]:        # budgets past both loops
            eng.submit(p, max_new_tokens=eng.cache_len - len(p))
    b.step()                                   # B's capture, first replay
    graph_b = b._decode_fused._graph
    times = {"replay": [], "to_host": []}
    replay = graph_b.replay

    def timed_replay():
        t0 = time.perf_counter()
        replay()
        times["replay"].append((time.perf_counter() - t0) * 1e3)
    graph_b.replay = timed_replay
    to_host = b._step_fused_impl

    def timed_impl(*args):
        t0 = time.perf_counter()
        out = to_host(*args)
        times["to_host"].append((time.perf_counter() - t0) * 1e3)
        return out
    b._step_fused_impl = timed_impl
    capturing, release = threading.Event(), threading.Event()
    body = a._decode_fused.body

    def held(*args):
        if torch.cuda.is_current_stream_capturing():
            capturing.set()
            release.wait(10)
        return body(*args)
    a._decode_fused.body = held
    thread = threading.Thread(target=a.step)
    thread.start()
    assert capturing.wait(120), "A never started its capture"
    t0 = time.perf_counter()
    during = 0
    while time.perf_counter() - t0 < hold_s:
        b.step()
        during += 1
    release.set()
    thread.join(120)
    n = len(times["replay"])
    alone_t0 = time.perf_counter()
    for _ in range(during):
        b.step()
    torch.cuda.synchronize()
    return {"dispatches_while_open": during, "hold_s": hold_s,
            "replay_ms_while_open": times["replay"][:n],
            "dispatch_ms_while_open": times["to_host"][:n],
            "replay_ms_alone": times["replay"][n:],
            "dispatch_ms_alone": times["to_host"][n:],
            "alone_s": time.perf_counter() - alone_t0,
            "a_finished": not thread.is_alive()}


def gateway_round(params, cfg, requests, fused, async_workers) -> dict:
    from repro_torch.gateway.gateway import Gateway
    from repro_torch.gateway.metrics import percentile
    gw = Gateway.build(params, cfg, replicas=2, batch_slots=8,
                       cache_len=512, kv_layout="paged", block_size=16,
                       prefill_mode="bulk", fused_tokens=fused,
                       async_workers=async_workers, device="cuda")
    try:
        for p, _, n in requests:                 # captures, first calls
            gw.submit(p, max_new_tokens=n)
        gw.run()
        gw.metrics.requests.clear()
        for r in gw.replicas:
            r.engine.step_times.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = [gw.submit(p, max_new_tokens=n) for p, _, n in requests]
        gw.run()
        gw.shutdown()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        gw.shutdown()
    assert all(h.done for h in handles)
    ttft = [h.metrics.ttft for h in handles]
    itl = [x for h in handles for x in h.metrics.inter_token_latencies]
    return {"wall_s": wall,
            "tokens_per_s": sum(len(h.output) for h in handles) / wall,
            "ttft_p50_ms": percentile(ttft, 50) * 1e3,
            "ttft_p95_ms": percentile(ttft, 95) * 1e3,
            "itl_p50_ms": percentile(itl, 50) * 1e3,
            "itl_p95_ms": percentile(itl, 95) * 1e3,
            "steps": [{k: h.n for k, h in r.engine.step_times.items()}
                      for r in gw.replicas]}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_gateway: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    cfg = smoke.full_config("bfloat16")
    params = smoke.make_model(cfg, "cuda")
    requests = smoke.greedy(smoke.make_requests(cfg))
    out = {"card": card, "capture_ms": {}, "gateway": {}}
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", default="1,2,3,4,5,6",
                    help="comma-separated numbers of the measurements to "
                    "run (see the module docstring)")
    sections = {int(x) for x in ap.parse_args().sections.split(",")}

    warm = engine(params, cfg, 1)               # cuBLAS set-up etc.
    for p, _, _ in requests[:4]:
        warm.submit(p, max_new_tokens=4)
    warm.run()
    del warm

    for name, peer in (("alone", None), ("python_spin", spin),
                       ("eager_engine", eager_peer(params, cfg, requests))):
        if 1 not in sections:
            break
        ms = out["capture_ms"][name] = capture_ms(params, cfg, requests,
                                                  peer)
        print(f"capture {name}: {ms:.1f} ms", flush=True)
        torch.cuda.empty_cache()

    rounds = [("sync", 1, False), ("sync", FUSED, False),
              ("async", 1, True), ("async", FUSED, True)]
    for mode, fused, async_workers in rounds:
        if 2 not in sections:
            break
        r = gateway_round(params, cfg, requests, fused, async_workers)
        key = f"{mode} fused_tokens={fused}"
        out["gateway"][key] = r
        print(f"{key}: {r['wall_s']:.3f} s, {r['tokens_per_s']:.1f} "
              f"tokens/s, ttft p50 {r['ttft_p50_ms']:.1f} p95 "
              f"{r['ttft_p95_ms']:.1f} ms, itl p50 {r['itl_p50_ms']:.2f} p95 "
              f"{r['itl_p95_ms']:.2f} ms, steps {r['steps']}", flush=True)
        torch.cuda.empty_cache()
    if 3 in sections:
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-4)
        try:
            r = gateway_round(params, cfg, requests, FUSED, True)
        finally:
            sys.setswitchinterval(interval)
        out["gateway"]["async fused_tokens=8 switchinterval=0.1ms"] = r
        print(f"async fused_tokens=8, switch interval 0.1 ms: "
              f"{r['wall_s']:.3f} s, {r['tokens_per_s']:.1f} tokens/s, itl "
              f"p95 {r['itl_p95_ms']:.2f} ms", flush=True)
    if 4 in sections:
        trips = out["round_trips"] = trips_during_capture(params, cfg,
                                                          requests)
        print(f"round trips: alone {trips['alone_1s']} in 1 s; during a "
              f"{trips['capture_ms']:.1f} ms capture "
              f"{trips['during_capture']}", flush=True)
        torch.cuda.empty_cache()
    if 6 in sections:
        r = out["open_capture"] = replays_beside_open_capture(
            params, cfg, requests)
        print(f"beside an open capture ({r['hold_s']} s): "
              f"{r['dispatches_while_open']} fused dispatches; replay ms "
              f"{[round(x, 2) for x in r['replay_ms_while_open']]}, dispatch "
              f"ms {[round(x, 1) for x in r['dispatch_ms_while_open']]}; "
              f"alone: replay ms "
              f"{[round(x, 2) for x in r['replay_ms_alone']]}, dispatch ms "
              f"{[round(x, 1) for x in r['dispatch_ms_alone']]}; A finished "
              f"{r['a_finished']}", flush=True)
        torch.cuda.empty_cache()
    if 5 in sections:
        events = out["timeline"] = timeline(params, cfg, requests)
        for rid in (0, 1):
            print(f"replica {rid}: " + ", ".join(
                f"{what} {a:.0f}-{b:.0f}" for r, what, a, b in
                sorted(events, key=lambda e: e[2]) if r == rid), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
