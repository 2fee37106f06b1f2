"""One run of one cell: set-up, the measured window, the reading of the
trace, the comparison, and the result line's contents.

Set-up (all of it counted in `setup_s`, from the process's start): the
kernels built or found in the checkout's `build/`, the weights drawn on
the device as the configuration's family names them (`weights.make`),
one gateway over one paged, fused engine, the warm-up of the prefill
lengths the mix can send and of the fused and single decode steps, and a
shared mix's documents prefilled once.

The window is a closed loop: `clients` clients each submit a request, wait
until it has finished, and submit the next; no request is submitted after
the window's end. Tokens are timed when the client's callback receives
them. With `trace`, the program's span tracer is on for the window, the
harness times each `Gateway.step` and taps the decode dispatches' inputs,
and `torch.profiler` records the window's last `PROFILE_SECONDS`.
"""
from __future__ import annotations

import gc
import time
from typing import List, Optional

import numpy as np
import torch

from portbench import check, e2e, model, profile, spec, traffic, weights

PROFILE_SECONDS = 2.0
SPAN_CAPACITY = 1 << 20


def _clock() -> float:
    return time.perf_counter()


def build_gateway(params, cfg, mix: dict, device):
    from repro_torch.gateway.gateway import Gateway
    return Gateway.build(params, cfg, replicas=1, batch_slots=mix["slots"],
                         cache_len=mix["cache_len"],
                         prefill_mode=mix["prefill_mode"], kv_layout="paged",
                         block_size=mix["block_size"],
                         fused_tokens=mix["fused_tokens"],
                         scheduler=mix["scheduler"], device=device)


def _run_all(gw, prompts, max_new: int):
    handles = [gw.submit(p, max_new_tokens=max_new) for p in prompts]
    gw.run()
    bad = [h.status for h in handles if h.status != "done"]
    if bad:
        raise RuntimeError(f"set-up requests ended {bad}")


def warm(gw, mix: dict, vocab: int, seed: int):
    """One request per prefill length bucket the window can send, each
    long enough for fused dispatches and the single steps of its end."""
    from repro_torch.serve.step import bucket_len
    lo, hi = traffic.prefill_lengths(mix)
    longest = {}
    for n in range(lo, hi + 1):
        longest[bucket_len(n, mix["cache_len"])] = n
    rng = np.random.default_rng([seed % 2 ** 64, 3])
    prompts = [[traffic.WARMUP_TOKEN] + rng.integers(
        traffic.FIRST_TOKEN, vocab, n - 1).tolist()
        for n in sorted(longest.values())]
    for a in range(0, len(prompts), mix["slots"]):
        _run_all(gw, prompts[a:a + mix["slots"]],
                 2 * mix["fused_tokens"] + 2)


class Probe:
    """Trace-run taps around the program's calls: the wall time of each
    `Gateway.step`, the inputs of each decode dispatch (positions, live
    slots, budgets), and labelled host ranges for the profiler."""

    def __init__(self, gw):
        eng = gw.replicas[0].engine
        self.n_fused = eng.fused_tokens
        self.steps: List[tuple] = []
        self.fused: List[dict] = []
        self.single: List[dict] = []
        self.recording = False
        self.profiling = False
        probe = self
        fused = eng._decode_fused

        class FusedTap:
            def __call__(self, params, tokens, pos, cache, table, eos, live,
                         steps):
                probe._tap_fused(pos, live, steps)
                return fused(params, tokens, pos, cache, table, eos, live,
                             steps)

            def __getattr__(self, name):
                return getattr(fused, name)

        if fused is not None:
            eng._decode_fused = FusedTap()
        decode = eng._decode_tok

        def decode_tap(params, tokens, pos, cache, table):
            probe._tap_single(pos, table)
            return decode(params, tokens, pos, cache, table)

        eng._decode_tok = decode_tap
        for obj, attr, label in ((eng, "_admit", "engine.admit"),
                                 (eng, "_step_fused", "engine.fused"),
                                 (gw, "_dispatch_ready", "gateway.dispatch")):
            setattr(obj, attr, self._labelled(getattr(obj, attr), label))

    @staticmethod
    def _labelled(fn, label):
        def wrapper(*a, **kw):
            with torch.profiler.record_function(profile.LABEL_PREFIX + label):
                return fn(*a, **kw)
        return wrapper

    def _tap_fused(self, pos, live, steps):
        if not self.recording:
            return
        p, lv, st = pos.tolist(), live.tolist(), steps.tolist()
        self.fused.append({"profiled": self.profiling, "slots": [
            (p[s], min(self.n_fused, st[s])) for s in range(len(p))
            if lv[s] and st[s] > 0]})

    def _tap_single(self, pos, table):
        if not self.recording:
            return
        p, live = pos.tolist(), (table[:, 0] != 0).tolist()
        self.single.append({"profiled": self.profiling, "slots": [
            (p[s], 1) for s in range(len(p)) if live[s]]})


class Profiler:
    """`torch.profiler` over the last whole gateway steps of the window
    (the loop is steady there), with their range labelled. It is stopped,
    and its trace reduced, after the window has closed."""

    def __init__(self, probe: Probe, t0: float, seconds: float):
        self.start_at = t0 + seconds - min(PROFILE_SECONDS, seconds)
        self.probe = probe
        self.prof = None
        self.label = None
        self.trace = None

    def before_step(self, now: float):
        if self.prof is None and now >= self.start_at:
            from torch.profiler import ProfilerActivity, profile as tprof
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = tprof(activities=acts)
            self.prof.start()
            self.label = torch.profiler.record_function(profile.WINDOW_LABEL)
            self.label.__enter__()
            self.probe.profiling = True

    def stop(self):
        if self.prof is None:
            return
        self.probe.profiling = False
        self.label.__exit__(None, None, None)
        self.prof.stop()
        self.trace = profile.reduce(self.prof)
        self.prof = None


def closed_loop(gw, requests: traffic.Traffic, clients: int, seconds: float,
                probe: Optional[Probe] = None,
                profiler: Optional[Profiler] = None):
    """Drive the gateway for `seconds`; returns (client requests, t0, t1)."""
    reqs: List[e2e.ClientRequest] = []
    active: List[Optional[e2e.ClientRequest]] = [None] * clients
    t0 = _clock()
    t1 = t0 + seconds
    n_steps = 0
    while True:
        now = _clock()
        if now >= t1:
            break
        for c in range(clients):
            r = active[c]
            if r is not None and not r.handle.finished:
                continue
            prompt, max_new = requests.next()
            r = e2e.ClientRequest(prompt, max_new, _clock())
            r.handle = gw.submit(prompt, max_new_tokens=max_new,
                                 on_token=_receiver(r))
            active[c] = r
            reqs.append(r)
        if profiler is not None:
            profiler.before_step(_clock())
        if probe is not None:
            a = _clock()
            gw.step()
            probe.steps.append((a, _clock()))
        else:
            gw.step()
        n_steps += 1
        if n_steps % 256 == 0:
            gw.reap()
    if profiler is not None:
        profiler.stop()
    for r in reqs:
        r.status = r.handle.status
    return reqs, t0, t1


def _receiver(r: e2e.ClientRequest):
    def on_token(tok):
        r.times.append(_clock())
        r.tokens.append(int(tok))
    return on_token


def _spans(tracer, t0: float) -> List[tuple]:
    return [(s.name, s.t0, s.t0 + s.dur, s.args or {})
            for s in list(tracer._ring) if s.t0 >= t0]


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             control: bool = False) -> dict:
    """One run: returns {"metrics", "attempted", "failed", "checks",
    "correct", "device", "breakdown"?, "readings"}."""
    t_start = _clock() if t_start is None else t_start
    dev = torch.device(device)
    m, mix = cell.config["model"], cell.traffic
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build()
        torch.cuda.reset_peak_memory_stats(dev)
    w = weights.make(m, seed, dev, cell.family)
    cfg = model.model_config(m)
    params = model.program_params(w, m, cfg, cell.family)
    gw = build_gateway(params, cfg, mix, dev)
    requests = traffic.Traffic(mix, m["vocab_size"], seed)
    warm(gw, mix, m["vocab_size"], seed)
    if requests.docs:
        _run_all(gw, requests.docs, 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = _clock() - t_start

    from repro_torch.obs import trace as otrace
    eng = gw.replicas[0].engine
    probe = profiler = tracer = None
    cache0 = dict(eng.cache_metrics.as_dict())
    if trace:
        probe = Probe(gw)
        tracer = otrace.enable(SPAN_CAPACITY)
        probe.recording = True
    t_window = _clock()
    if trace:
        profiler = Profiler(probe, t_window, seconds)
    reqs, t0, t1 = closed_loop(gw, requests, mix["clients"], seconds,
                               probe, profiler)
    if trace:
        probe.recording = False
        otrace.disable()
    cache1 = dict(eng.cache_metrics.as_dict())
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    record = None
    if trace:
        record = {"model": m, "family": cell.family, "mix": mix,
                  "t0": t0, "t1": t1,
                  "window_s": t1 - t0, "spans": _spans(tracer, t_window),
                  "spans_dropped": tracer.dropped,
                  "gateway_steps": probe.steps, "fused": probe.fused,
                  "single": probe.single,
                  "cache": {"start": cache0, "end": cache1},
                  "profile": profiler.trace}
    # the program's state goes before the reference runs (a request's
    # handle reaches the gateway, and through it the engine's pools)
    gw.shutdown()
    for r in reqs:
        r.handle = None
    del gw, eng, params, probe, profiler, tracer, requests
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    picked = check.sample(reqs, seed, cell.limits["sample_tokens"],
                          cell.limits["sample_requests"])
    readings = check.readings(cell.family, w, m, mix, picked,
                              control=control)
    attempted = len(reqs)
    failed = sum(r.status in ("rejected", "failed") for r in reqs)
    short = sum(len(r.tokens) != r.max_new for r in reqs
                if r.status == "done")
    checks = {
        "max_logit_gap": {"value": readings["max_logit_gap"],
                          "limit": cell.limits["max_logit_gap"]["limit"]},
        "short_answers": {"value": short, "limit": 0},
        "failed_requests": {"value": failed, "limit": 0},
    }
    correct = bool(picked) and all(
        c["value"] is not None and c["limit"] is not None
        and c["value"] <= c["limit"] for c in checks.values())

    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "readings": readings, "checks": checks}
    if trace:
        metrics = {}
        units = {mdef["name"]: mdef["unit"] for mdef in cell.per_layer}
        for name, read in spec.readers(cell, cell.root).items():
            v = read(record)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
        out["metrics"] = metrics
        tr = record["profile"]
        out["busy_s"] = profile.busy_s(tr["ops"]) if tr else None
        out["window_s"] = (tr["window"][1] - tr["window"][0]) if tr else None
        out["breakdown"] = profile.breakdown(tr) if tr else None
        out["spans_dropped"] = record["spans_dropped"]
    else:
        metrics = {}
        for mdef in cell.end_to_end:
            if mdef["name"] == "setup_s":
                v = setup_s
            else:
                v = e2e.METRICS[mdef["name"]](reqs, t0, t1)
            if v is not None:
                metrics[mdef["name"]] = {"value": v, "unit": mdef["unit"]}
        out["metrics"] = metrics
    out["memory_peak_bytes"] = int(peak)
    out["setup_s"] = setup_s
    return out
