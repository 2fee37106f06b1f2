"""Reporting — the plot.ly / dashboard tier as a library.

Generates the paper's figures from the result store as text/CSV/markdown
artifacts: training time vs hidden layers (Fig 5), queue dashboard (Fig 6),
worker status (Fig 7), plus the accuracy-vs-capacity table behind finding
F1 and the activation comparison behind F3. ASCII scatter plots keep the
"visualization" promise in a terminal-only container.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.results import ResultStore


# ----------------------------------------------------------------- extraction

def time_vs_layers(results: ResultStore, session_id=None) -> List[Tuple[int, float]]:
    """(n_hidden_layers, mean train_time) rows — paper Fig 5."""
    groups = results.aggregate("metrics.n_hidden_layers", "train_time",
                               session_id)
    return sorted((int(k), float(np.mean(v))) for k, v in groups.items())


def accuracy_vs_capacity(results: ResultStore, session_id=None,
                         key="metrics.n_params") -> List[Tuple[int, float]]:
    """(capacity, mean test accuracy) — the critical-mass curve (F1)."""
    groups = results.aggregate(key, "metrics.accuracy", session_id)
    return sorted((int(k), float(np.mean(v))) for k, v in groups.items())


def accuracy_by_activation(results: ResultStore, session_id=None) -> Dict[str, float]:
    """mean accuracy per activation cycle (F3)."""
    out: Dict[str, List[float]] = {}
    for d in results.find(session_id, status="ok"):
        acts = "+".join(d["params"].get("activations", []))
        acc = d["metrics"].get("accuracy")
        if acc is not None:
            out.setdefault(acts, []).append(acc)
    return {k: float(np.mean(v)) for k, v in sorted(out.items())}


def failure_report(results: ResultStore, session_id=None) -> dict:
    ok = results.count(session_id, status="ok")
    failed = results.count(session_id, status="failed")
    return {"ok": ok, "failed": failed,
            "fail_forward_rate": failed / max(ok + failed, 1)}


# ----------------------------------------------------------------- rendering

def ascii_scatter(rows: Sequence[Tuple[float, float]], *, width=60, height=16,
                  xlabel="x", ylabel="y", logx=False) -> str:
    if not rows:
        return "(no data)"
    xs = np.array([r[0] for r in rows], float)
    ys = np.array([r[1] for r in rows], float)
    if logx:
        xs = np.log10(np.maximum(xs, 1e-12))
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    x1 = x1 if x1 > x0 else x0 + 1
    y1 = y1 if y1 > y0 else y0 + 1
    grid = [[" "] * width for _ in range(height)]
    for x, y in zip(xs, ys):
        c = int((x - x0) / (x1 - x0) * (width - 1))
        r = int((y - y0) / (y1 - y0) * (height - 1))
        grid[height - 1 - r][c] = "*"
    lines = ["".join(row) for row in grid]
    header = f"{ylabel} [{y0:.4g} .. {y1:.4g}]   {xlabel}" + \
        (" (log10)" if logx else "") + f" [{x0:.4g} .. {x1:.4g}]"
    return header + "\n" + "\n".join("|" + ln for ln in lines) + \
        "\n+" + "-" * width


def to_csv(rows: Sequence[Tuple], header: Sequence[str]) -> str:
    out = [",".join(header)]
    out += [",".join(str(c) for c in r) for r in rows]
    return "\n".join(out)


def to_markdown(rows: Sequence[Tuple], header: Sequence[str]) -> str:
    out = ["| " + " | ".join(header) + " |",
           "|" + "|".join("---" for _ in header) + "|"]
    out += ["| " + " | ".join(str(c) for c in r) + " |" for r in rows]
    return "\n".join(out)


# ------------------------------------------------------- serving dashboards

def _fmt_value(v) -> str:
    """Dashboard cell: empty-series metrics arrive as None (never NaN —
    see `gateway.metrics.percentile`) and render as an em-dash; a NaN that
    slips in from any other producer gets the same treatment rather than
    printing a literal `nan` row."""
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return "—"
    return f"{v:.3f}" if isinstance(v, float) else str(v)


def _metric_table(metrics: Dict[str, float], header=("metric", "value")) -> str:
    rows = [(k, _fmt_value(v)) for k, v in metrics.items()]
    return to_markdown(rows, header)


def gateway_summary_table(summary: Dict[str, float]) -> str:
    """Markdown table of one gateway run's throughput/latency summary
    (`repro_torch.gateway.GatewayMetrics.summary()`), the serving analogue of
    the paper's Fig 6 queue dashboard."""
    return _metric_table(summary)


def gauge_series(gauges: Sequence[Tuple[float, int, int]], column: int
                 ) -> List[Tuple[float, float]]:
    """(elapsed_seconds, value) rows from step-sampled gateway gauges.
    column 1 = queue depth, column 2 = active slots."""
    if not gauges:
        return []
    t0 = gauges[0][0]
    return [(g[0] - t0, float(g[column])) for g in gauges]


def kvcache_summary_table(kv: Dict[str, float]) -> str:
    """Markdown table of the paged KV cache's hit/miss/eviction counters
    (`repro_torch.kvcache.CacheMetrics.as_dict()`, aggregated across replicas
    by `Gateway.kvcache_summary`). The reuse_frac row is the headline: the
    fraction of prompt tokens served from cached KV instead of prefill."""
    return _metric_table(kv, ("kv cache metric", "value"))


def spec_summary_table(spec: Dict[str, float]) -> str:
    """Markdown table of the speculative-decoding counters
    (`ServeEngine.spec_metrics`, aggregated across replicas by
    `Gateway.spec_summary`). acceptance_rate is the headline: the fraction
    of drafted tokens the target model verified; tokens_per_dispatch is
    the realized decode speedup lever (accepted drafts + bonus token per
    verify forward)."""
    return _metric_table(spec, ("speculation metric", "value"))


def scheduler_summary_table(sched: Dict[str, float]) -> str:
    """Markdown table of the chunked-prefill scheduler counters
    (`ServeEngine.scheduler_metrics`, aggregated across replicas by
    `Gateway.scheduler_summary`). tokens_per_chunk close to chunk_budget
    means the budget is the binding constraint (long prompts saturating
    each mixed step); prefills_in_flight > 0 at the end of a run means
    work was evicted or abandoned mid-prefill."""
    return _metric_table(sched, ("scheduler metric", "value"))


def gateway_dashboard(summary: Dict[str, float],
                      gauges: Sequence[Tuple[float, int, int]],
                      kvcache: Optional[Dict[str, float]] = None,
                      spec: Optional[Dict[str, float]] = None,
                      scheduler: Optional[Dict[str, float]] = None) -> str:
    """Full text dashboard: summary table + queue-depth-over-time (Fig 6
    shape) + slot-occupancy-over-time (Fig 7 shape, worker status) +
    optional paged KV-cache, speculative-decoding, and chunked-prefill
    scheduler counters."""
    parts = ["## gateway summary", gateway_summary_table(summary)]
    if kvcache:
        parts += ["\n## kv cache (paged)", kvcache_summary_table(kvcache)]
    if spec:
        parts += ["\n## speculative decode", spec_summary_table(spec)]
    if scheduler:
        parts += ["\n## chunked-prefill scheduler",
                  scheduler_summary_table(scheduler)]
    depth = gauge_series(gauges, 1)
    if depth:
        parts += ["\n## queue depth (Fig 6)",
                  ascii_scatter(depth, xlabel="elapsed s",
                                ylabel="queue depth")]
    active = gauge_series(gauges, 2)
    if active:
        parts += ["\n## active slots (Fig 7)",
                  ascii_scatter(active, xlabel="elapsed s",
                                ylabel="busy slots")]
    return "\n".join(parts)


def engine_steps_table(steps: Dict[str, float]) -> str:
    """Markdown table of the engine's host-side step-latency histogram
    stats (`Gateway.engine_step_summary`): ``<kind>_<stat>`` rows in ms,
    one group per step type (prefill/decode/fused/spec/mixed)."""
    return _metric_table(steps, ("engine step metric", "value (ms)"))


def trace_stats_table(tr: Dict[str, float]) -> str:
    """Markdown table of the span tracer's ring-buffer counters
    (`repro_torch.obs.trace.Tracer.stats`)."""
    return _metric_table(tr, ("tracer metric", "value"))


def slo_dashboard(slo: Dict[str, dict]) -> str:
    """Render an `SLOTracker.report()`: one row per tier (premium first)
    with attainment / goodput / shed-by-cause, a per-tenant table when
    tenants were tagged, and the overall roll-up line. `attainment` is
    met/finished over *served* requests; shed and failed requests are
    separate columns — a 429 is a capacity decision, not a latency miss."""
    header = ("tier", "spec", "submitted", "finished", "attainment",
              "goodput tok/s", "shed(deadline)", "shed(429)", "failed")
    rows = []
    for tier, d in sorted(slo.get("tiers", {}).items(),
                          key=lambda kv: int(kv[0])):
        rows.append((tier, d.get("spec", "?"), d["submitted"], d["finished"],
                     _fmt_value(d["attainment"]),
                     _fmt_value(d["goodput_tok_s"]),
                     d["shed_deadline"], d["shed_capacity_429"], d["failed"]))
    parts = ["## SLO attainment by tier", to_markdown(rows, header)]
    tenants = slo.get("tenants", {})
    if tenants:
        theader = ("tenant", "tier", "submitted", "finished", "attainment",
                   "shed(deadline)", "shed(429)", "failed")
        trows = [(name, d.get("tier", 0), d["submitted"], d["finished"],
                  _fmt_value(d["attainment"]),
                  d["shed_deadline"], d["shed_capacity_429"], d["failed"])
                 for name, d in sorted(tenants.items())]
        parts += ["\n### per tenant", to_markdown(trows, theader)]
    o = slo.get("overall")
    if o:
        parts.append(
            f"\noverall: {o['met']}/{o['finished']} met "
            f"(attainment {_fmt_value(o['attainment'])}), goodput "
            f"{_fmt_value(o['goodput_tok_s'])} tok/s over "
            f"{_fmt_value(o['duration_s'])} s")
    return "\n".join(parts)


def worker_health_table(workers: Dict[str, object]) -> str:
    """Markdown table of the async worker fleet
    (`Gateway.workers_summary`): one row per replica worker thread with
    its pump/step/error counters — the Fig 7 worker-status panel for
    threaded mode, where slot gauges alone can't show which worker died."""
    header = ("worker", "alive", "pumps", "engine steps", "pump errors")
    rows = [(f"replica{s['replica']}", "yes" if s["alive"] else "NO",
             s["pumps"], s["engine_steps"], s["pump_errors"])
            for s in workers.get("per_worker", [])]
    rows.append(("fleet total", f"{workers['alive']}/{workers['n_workers']}",
                 workers["pumps"], workers["engine_steps"],
                 workers["pump_errors"]))
    return to_markdown(rows, header)


def ledger_dashboard(report: Dict[str, object]) -> str:
    """Render a `UtilizationLedger.report()`: per-tenant device-time
    attribution (the cost denominator to the SLO dashboard's outcome
    numerator), per-tier roll-up, device time by step kind, and the
    conservation line — attributed vs measured device-seconds, which
    `bench_obs` bars at 1%."""
    header = ("tenant", "tier", "device s", "share", "tokens",
              "block·s", "steps")
    rows = [(name, d["tier"] if d["tier"] is not None else "—",
             _fmt_value(d["device_s"]), f"{d['frac']:.1%}", d["tokens"],
             _fmt_value(d["block_s"]), d["steps"])
            for name, d in sorted(report.get("tenants", {}).items(),
                                  key=lambda kv: -kv[1]["device_s"])]
    parts = ["## utilization ledger (device-time attribution)",
             to_markdown(rows, header)]
    tiers = report.get("tiers", {})
    if len(tiers) > 1:
        theader = ("tier", "device s", "tokens", "block·s")
        trows = [(t, _fmt_value(d["device_s"]), d["tokens"],
                  _fmt_value(d["block_s"]))
                 for t, d in sorted(tiers.items())]
        parts += ["\n### per tier", to_markdown(trows, theader)]
    kinds = report.get("by_kind", {})
    if kinds:
        parts += ["\n### device time by step kind",
                  to_markdown([(k, _fmt_value(v))
                               for k, v in sorted(kinds.items())],
                              ("kind", "device s"))]
    parts.append(
        f"\nattributed {_fmt_value(report['attributed_device_s'])} s of "
        f"{_fmt_value(report['total_device_s'])} s measured over "
        f"{report['steps']} steps (conservation err "
        f"{report['conservation_err_frac']:.2e}); pool occupancy "
        f"{_fmt_value(report['pool_block_s'])} block·s")
    return "\n".join(parts)


# ------------------------------------------------- time-series sparklines

_SPARK = "▁▂▃▄▅▆▇█"

#: series the live `serve --watch` panel shows by default (any
#: ``pressure.shed_*`` series that appears is appended automatically)
DEFAULT_PANEL_SERIES = ("gateway.queue_depth", "gateway.active_slots",
                        "pressure.brownout_level")


def sparkline(values: Sequence[float], *, width: int = 48,
              lo: Optional[float] = None, hi: Optional[float] = None) -> str:
    """Render a value sequence as one line of block glyphs. Longer
    sequences are bucket-mean resampled to `width`; `lo`/`hi` pin the
    scale (default: the data's own min/max, flat series render low)."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        buckets = []
        for i in range(width):
            a = i * len(vals) // width
            b = max(a + 1, (i + 1) * len(vals) // width)
            chunk = vals[a:b]
            buckets.append(sum(chunk) / len(chunk))
        vals = buckets
    v0 = min(vals) if lo is None else float(lo)
    v1 = max(vals) if hi is None else float(hi)
    span = (v1 - v0) or 1.0
    top = len(_SPARK) - 1
    return "".join(
        _SPARK[max(0, min(top, int((v - v0) / span * top + 0.5)))]
        for v in vals)


def timeseries_panel(sampler, names: Optional[Sequence[str]] = None, *,
                     width: int = 48,
                     window_s: Optional[float] = None) -> str:
    """Terminal sparkline panel over a `TimeSeriesSampler`'s rings — the
    `serve --watch` view. One line per series: name, sparkline over the
    trailing `window_s` (full retention when None), last/min/max. Empty
    string when no requested series has points yet (watch threads print
    nothing rather than a bare header)."""
    if names is None:
        avail = sampler.names()
        names = [n for n in DEFAULT_PANEL_SERIES if n in avail]
        names += [n for n in avail if n.startswith("pressure.shed_")]
    lines = []
    for name in names:
        pts = sampler.series(name)
        if window_s is not None and pts:
            cut = pts[-1][0] - window_s
            pts = [p for p in pts if p[0] >= cut]
        if not pts:
            continue
        vals = [v for _, v in pts]
        lines.append(f"{name:<28} {sparkline(vals, width=width)}  "
                     f"last={_fmt_value(vals[-1])} min={_fmt_value(min(vals))}"
                     f" max={_fmt_value(max(vals))}")
    if not lines:
        return ""
    return "\n".join(["## telemetry (sparklines)"] + lines)


def sampler_stats_table(st: Dict[str, object]) -> str:
    """Markdown table of the continuous-telemetry sampler's counters
    (`repro_torch.obs.timeseries.TimeSeriesSampler.stats`)."""
    return _metric_table(st, ("sampler metric", "value"))


def flight_stats_table(fl: Dict[str, object]) -> str:
    """Markdown table of the flight recorder's state
    (`repro_torch.obs.flight.FlightRecorder.stats`)."""
    fl = dict(fl)
    triggers = fl.pop("triggers", {}) or {}
    for reason, n in sorted(triggers.items()):
        fl[f"trigger_{reason}"] = n
    return _metric_table(fl, ("flight recorder", "value"))


def _health_warnings(snapshot: Dict[str, dict]) -> List[str]:
    """The things that must not be buried in scope dicts: dropped trace
    spans (the timeline is lying about what happened), illegal lifecycle
    transitions (a state-machine bug), and flight-recorder dumps (an
    anomaly trigger fired). Surfaced as a warning block at the very top
    of the dashboard when nonzero."""
    warns = []
    dropped = (snapshot.get("trace") or {}).get("spans_dropped", 0)
    if dropped:
        warns.append(f"⚠ tracer dropped {dropped} spans (ring buffer "
                     "full — raise capacity or trace a shorter window)")
    illegal = (snapshot.get("gateway") or {}).get("illegal_transitions", 0)
    if illegal:
        warns.append(f"⚠ {illegal} illegal request-lifecycle transitions "
                     "(state-machine bug — see logs / flight recorder)")
    fl = snapshot.get("flight") or {}
    if fl.get("dumps"):
        warns.append(f"⚠ flight recorder fired {fl['dumps']} dump(s), "
                     f"last: {fl.get('last_dump')}")
    return warns


def unified_dashboard(snapshot: Dict[str, dict],
                      gauges: Sequence[Tuple[float, int, int]] = ()) -> str:
    """One dashboard from one dict: renders a `Gateway.snapshot()` —
    every registered metrics scope — as a single document. Health
    warnings (dropped spans, illegal transitions, flight-recorder dumps)
    lead; the gateway / kvcache / speculation / scheduler sections are
    exactly the `gateway_dashboard` ones (same tables, same Fig 6/7 gauge
    plots when `gauges` is passed); the SLO, engine step-latency, fused
    decode graph, span tracer, and flight-recorder sections follow."""
    parts = []
    warns = _health_warnings(snapshot)
    if warns:
        parts.append("\n".join(warns) + "\n")
    parts.append(gateway_dashboard(snapshot.get("gateway", {}), gauges,
                                   kvcache=snapshot.get("kvcache"),
                                   spec=snapshot.get("speculation"),
                                   scheduler=snapshot.get("scheduler")))
    if snapshot.get("workers"):
        parts += ["\n## worker fleet",
                  worker_health_table(snapshot["workers"])]
    if snapshot.get("slo"):
        parts += ["", slo_dashboard(snapshot["slo"])]
    if snapshot.get("ledger"):
        parts += ["", ledger_dashboard(snapshot["ledger"])]
    if snapshot.get("engine_steps"):
        parts += ["\n## engine step latency",
                  engine_steps_table(snapshot["engine_steps"])]
    if snapshot.get("graph"):
        parts += ["\n## fused decode graph",
                  _metric_table(snapshot["graph"], ("graph counter", "value"))]
    if snapshot.get("sampler"):
        parts += ["\n## telemetry sampler",
                  sampler_stats_table(snapshot["sampler"])]
    if snapshot.get("trace"):
        parts += ["\n## span tracer", trace_stats_table(snapshot["trace"])]
    if snapshot.get("flight"):
        parts += ["\n## flight recorder",
                  flight_stats_table(snapshot["flight"])]
    return "\n".join(parts)


def linear_fit(rows: Sequence[Tuple[float, float]]) -> dict:
    """Least-squares fit + R^2 — used to validate finding F2 (time grows
    ~linearly with layer count)."""
    xs = np.array([r[0] for r in rows], float)
    ys = np.array([r[1] for r in rows], float)
    if len(xs) < 2:
        return {"slope": 0.0, "intercept": float(ys.mean()) if len(ys) else 0.0,
                "r2": 1.0}
    A = np.stack([xs, np.ones_like(xs)], axis=1)
    (slope, intercept), *_ = np.linalg.lstsq(A, ys, rcond=None)
    pred = slope * xs + intercept
    ss_res = float(np.sum((ys - pred) ** 2))
    ss_tot = float(np.sum((ys - ys.mean()) ** 2)) or 1e-12
    return {"slope": float(slope), "intercept": float(intercept),
            "r2": 1 - ss_res / ss_tot}


def critical_mass(rows: Sequence[Tuple[int, float]], *, tol=0.01) -> Optional[int]:
    """Smallest capacity whose accuracy is within `tol` of the best mean
    accuracy at any larger capacity — the paper's F1 'critical mass' point."""
    if not rows:
        return None
    best = max(a for _, a in rows)
    for cap, acc in rows:
        if acc >= best - tol:
            return cap
    return rows[-1][0]
