"""Device time by region on the card: what the fused graph's timing events
cost a replay, and what tracing costs the engine's steps.

    python3 tools/probe_regions.py --workload granite-moe-3b.longgen \
        [--src DIR] [--seed N] [--seconds S] [--replays R] [--prefills P]

Builds the benchmark cell's gateway as `portbench` does (weights drawn on
the card, the warm-up that captures the fused graph), then prints one
JSON line per section:

1. `prefill`: P prompts of the cell's traffic, each prefilled alone four
   times (untraced, traced, traced, untraced) with fresh tokens after the
   shared document, if any: the mean wall time of a prefill step in each
   state (the engine's always-on step histogram), the time of the
   timed steps' reading of their marks (`StepTimer.read`), and the host
   time inside the regions' marks per traced prefill.
2. `replay`: the slots filled from the traffic and `--fill-steps`
   gateway steps run (the same state in every tree), R replays of the
   captured fused graph on its own inputs, untraced, each between two
   CUDA events on the engine's stream; the median and quartiles in ms.
   Run the parent's `src/` (`--src`, unpacked under build/) and this one
   in turns to read the cost of the graph's timing events.
3. `fused`: a closed loop of the cell's clients for S seconds, tracing
   on for every other gateway step: the mean wall time of the fused
   steps in each state, and the time of their reading of the marks.
4. `device` (a tree with device regions only): the traced steps'
   `device` readings by step kind: mean total and covered ms, each
   region's share of the covered time, the widest and narrowest coverage
   (regions over covered time), the mean fused `engine.reconcile`, and
   the `graph.capture` spans among them.
5. `gaps` (with `--profile`, a tree with device regions only): a closed
   loop traced for `--profile` seconds under `torch.profiler`; the
   device's idle gaps in it, each put down to the innermost program span
   open on the host at its middle (the spans are mirrored as profiler
   ranges, on the device trace's clock): the five longest, and the idle
   time summed by span.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2],
            "n": len(xs)}


def _replays(eng, n: int):
    import torch
    graph = eng._decode_fused._graph
    out = []
    with torch.cuda.stream(eng._stream):
        graph.replay()
        eng._stream.synchronize()
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
    return out


def _prefill_ms(eng):
    h = eng.step_times.get("prefill")
    return (h.n, h.total) if h is not None else (0, 0.0)


def _prefills(gw, eng, requests, n: int, vocab: int, rng, otrace, reads):
    """Each prompt's length, prefilled alone: untraced, traced, traced,
    untraced; fresh tokens after the shared document, if any."""
    out = {"off": [], "on": []}
    spans = []
    for _ in range(n):
        prompt, _ = requests.next()
        keep = next((len(d) for d in requests.docs
                     if prompt[:len(d)] == d), 0)
        for mode in ("off", "on", "on", "off"):
            p = prompt[:keep] + rng.integers(
                2, vocab, len(prompt) - keep).tolist()
            if mode == "on":
                tracer = otrace.enable(1 << 16)
            n0, t0 = _prefill_ms(eng)
            h = gw.submit(p, max_new_tokens=1)
            gw.step()
            assert h.finished
            n1, t1 = _prefill_ms(eng)
            assert n1 == n0 + 1, (n0, n1)
            out[mode].append(t1 - t0)
            if mode == "on":
                otrace.disable()
                spans += list(tracer._ring)
    res = {m: statistics.mean(v) for m, v in out.items()}
    res["n"] = len(out["on"])
    res["overhead_pct"] = 100.0 * (res["on"] - res["off"]) / res["off"]
    if reads.get("prefill"):
        res["read_ms"] = statistics.mean(reads["prefill"])
    return res, spans


def _device(spans):
    by_kind = {}
    reconcile = []
    for s in spans:
        if s.name == "engine.reconcile" and s.args.get("step") == "fused":
            reconcile.append(1e3 * s.dur)
        if s.name != "engine.step" or not s.args or \
                "device" not in s.args:
            continue
        by_kind.setdefault(s.args["step"], []).append(s.args["device"])
    out = {}
    for kind, ds in by_kind.items():
        covered = [d.get("covered_ms", d["total_ms"]) for d in ds]
        names = sorted({k for d in ds for k in d} - {"total_ms",
                                                      "covered_ms"})
        sums = [sum(v for k, v in d.items()
                    if k not in ("total_ms", "covered_ms")) for d in ds]
        cov = [s / c for s, c in zip(sums, covered) if c > 0]
        out[kind] = {
            "n": len(ds),
            "total_ms": statistics.mean(d["total_ms"] for d in ds),
            "covered_ms": statistics.mean(covered),
            "share_pct": {k: 100.0 * sum(d.get(k, 0.0) for d in ds)
                          / sum(covered) for k in names},
            "coverage_pct": {"min": 100.0 * min(cov), "max": 100.0 * max(cov),
                             "mean": 100.0 * statistics.mean(cov)},
        }
    if reconcile:
        out["reconcile_ms"] = statistics.mean(reconcile)
    out["graph_capture_spans"] = sum(s.name == "graph.capture"
                                     for s in spans)
    return out


def _gaps(gw, requests, clients: int, seconds: float, otrace):
    """Idle gaps of a traced closed loop's last `seconds` under the
    profiler (after as long again unprofiled, so the loop is steady), by
    innermost program span."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from portbench import profile as pb
    handles = [None] * clients

    def loop(until):
        while time.perf_counter() < until:
            for c in range(clients):
                if handles[c] is None or handles[c].finished:
                    prompt, max_new = requests.next()
                    handles[c] = gw.submit(prompt, max_new_tokens=max_new)
            gw.step()
    otrace.enable(1 << 20)
    loop(time.perf_counter() + seconds)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(pb.WINDOW_LABEL):
            loop(time.perf_counter() + seconds)
        torch.cuda.synchronize()
    otrace.disable()
    trace = pb.reduce(prof)
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU and \
                e.is_user_annotation() and \
                not e.name().startswith(pb.LABEL_PREFIX):
            a = e.start_ns() * 1e-9
            spans.append((e.name(), a, a + e.duration_ns() * 1e-9))
    # an engine.step range holding a device.fused range is a fused
    # dispatch; the others are prefills (or single decode steps)
    fused = [(x, y) for n, x, y in spans if n == "device.fused"]
    spans = [(n + (" (fused)" if any(x <= f0 and f1 <= y for f0, f1 in fused)
                   else " (eager)") if n == "engine.step" else n, x, y)
             for n, x, y in spans]
    gaps = pb.idle_gaps(trace)
    lo, hi = trace["window"]
    by = {}
    labelled = []
    for a, b in gaps:
        name = pb.host_label(spans, (a + b) / 2) if any(
            x <= (a + b) / 2 <= y for _, x, y in spans) else "no span"
        by[name] = by.get(name, 0.0) + (b - a)
        labelled.append((b - a, name))
    labelled.sort(reverse=True)
    return {"window_s": hi - lo, "idle_s": sum(b - a for a, b in gaps),
            "busy_s": pb.busy_s(trace["ops"]),
            "longest": [[name, 1e3 * d] for d, name in labelled[:5]],
            "idle_ms_by_span": {k: 1e3 * v for k, v in
                                sorted(by.items(), key=lambda kv: -kv[1])},
            "device_ops_named_as_spans": sorted(
                {n for n, _, _ in trace["ops"]} & {n for n, _, _ in spans})}


def _loop(gw, requests, clients: int, seconds: float, eng, otrace,
          reads):
    """A closed loop, tracing on for every other gateway step; the fused
    steps' wall times by state."""
    handles = [None] * clients
    walls = {"off": [], "on": []}
    spans = []
    fused = eng._step_fused

    def timed(*a):
        t0 = time.perf_counter()
        out = fused(*a)
        walls["on" if otrace.enabled() else "off"].append(
            1e3 * (time.perf_counter() - t0))
        return out
    eng._step_fused = timed
    t_end = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < t_end:
        for c in range(clients):
            if handles[c] is None or handles[c].finished:
                prompt, max_new = requests.next()
                handles[c] = gw.submit(prompt, max_new_tokens=max_new)
        on = i % 2 == 1
        if on:
            tracer = otrace.enable(1 << 16)
        gw.step()
        if on:
            otrace.disable()
            spans += list(tracer._ring)
        i += 1
    del eng._step_fused
    res = {m: statistics.mean(v) for m, v in walls.items() if v}
    res["n"] = {m: len(v) for m, v in walls.items()}
    if "on" in res and "off" in res:
        res["overhead_pct"] = 100.0 * (res["on"] - res["off"]) / res["off"]
    if reads.get("fused"):
        res["read_ms"] = statistics.mean(reads["fused"])
    return res, spans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ whose repro_torch runs")
    ap.add_argument("--seed", type=int, default=2026101800)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--replays", type=int, default=40)
    ap.add_argument("--prefills", type=int, default=6)
    ap.add_argument("--fill-steps", type=int, default=6)
    ap.add_argument("--profile", type=float, default=0.0,
                    help="seconds of a profiled, traced closed loop")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import numpy as np
    import torch
    from portbench import model, session, spec, traffic, weights
    from repro_torch.kernels import build
    from repro_torch.obs import trace as otrace

    tag = {"workload": args.workload, "src": args.src, "card": _card()}
    cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    m, mix = cell.config["model"], cell.traffic
    dev = torch.device("cuda")
    build.build()
    w = weights.make(m, args.seed, dev)
    cfg = model.model_config(m)
    gw = session.build_gateway(model.program_params(w, m, cfg), cfg, mix,
                               dev)
    requests = traffic.Traffic(mix, m["vocab_size"], args.seed)
    session.warm(gw, mix, m["vocab_size"], args.seed)
    if requests.docs:
        session._run_all(gw, requests.docs, 1)
    eng = gw.replicas[0].engine
    traced_tree = hasattr(otrace, "region")
    reads = {}
    if traced_tree:
        read = otrace.StepTimer.read

        def timed_read(self):
            t0 = time.perf_counter()
            out = read(self)
            kind = "fused" if "covered_ms" in out else "prefill"
            reads.setdefault(kind, []).append(
                1e3 * (time.perf_counter() - t0))
            return out
        otrace.StepTimer.read = timed_read
        marks = {"s": 0.0}

        def clocked(fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    marks["s"] += time.perf_counter() - t0
            return wrapper
        for name in ("__enter__", "switch", "__exit__"):
            setattr(otrace._Region, name,
                    clocked(getattr(otrace._Region, name)))
    rng = np.random.default_rng(args.seed)
    res, spans = _prefills(gw, eng, requests, args.prefills, m["vocab_size"],
                           rng, otrace, reads)
    if traced_tree:
        res["region_host_ms"] = 1e3 * marks["s"] / max(1, res["n"])
    print(json.dumps({**tag, "section": "prefill", **res}), flush=True)

    # the same state in every tree: the slots filled, then a fixed count
    # of steps (greedy, untraced: the same tokens)
    for _ in range(mix["clients"]):
        prompt, max_new = requests.next()
        gw.submit(prompt, max_new_tokens=max_new)
    for _ in range(args.fill_steps):
        gw.step()
    torch.cuda.synchronize()
    rs = _replays(eng, args.replays)
    print(json.dumps({**tag, "section": "replay", **_quartiles(rs)}),
          flush=True)
    res, more = _loop(gw, requests, mix["clients"], args.seconds, eng,
                      otrace, reads)
    print(json.dumps({**tag, "section": "fused", **res}), flush=True)
    if traced_tree:
        print(json.dumps({**tag, "section": "device",
                          **_device(spans + more)}), flush=True)
    if traced_tree and args.profile:
        print(json.dumps({**tag, "section": "gaps", **_gaps(
            gw, requests, mix["clients"], args.profile, otrace)}),
            flush=True)
    gw.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
