"""Serving launcher: batched requests against a (reduced) model through the
queue-backed gateway — replica dispatch policies, per-request sampling,
optional token streaming, multi-tenant workload replay with per-tier SLO
judgment, an armable anomaly flight recorder, and a Fig 6/7-shaped
telemetry dashboard.

The port's copy of `repro.launch.serve`, with the reference's flags and
output lines, run as `python -m repro_torch.launch.serve`. It serves on
`--device` (default "cuda": without a CUDA device it stops, unless
`--device cpu` is given), with seeded torch weights (`init_lm` on a
`torch.Generator` seeded 0; the reference draws `jax.random.PRNGKey(0)`).
`--decode-kernel pallas` names the port's hand-written CUDA kernel, so
the reference's command lines run; without the flag each engine takes its
own default, the kernel on the paged layout.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.core import reporting
from repro_torch.gateway.gateway import POLICIES, BrownoutConfig, Gateway
from repro_torch.gateway.sampler import SamplingParams
from repro_torch.models import transformer as T
from repro_torch.obs import trace as otrace
from repro_torch.obs import slo as oslo
from repro_torch.obs import workload as owl


def _f(v, spec: str = ".1f") -> str:
    """Format a possibly-None metric (empty series) as an em-dash."""
    return "—" if v is None else format(v, spec)


def _drive(gw: Gateway, cfg, args) -> tuple:
    """Submit the run's requests — a multi-tenant workload trace when
    --workload is given, the synthetic prompt batch otherwise — and drive
    the gateway to completion. Returns (done_handles, elapsed_s)."""
    sampling = SamplingParams(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.seed)
    if args.workload:
        if args.workload == "synth":
            spec = owl.WorkloadSpec(
                seed=args.seed if args.seed is not None else 0,
                duration_s=args.workload_duration,
                base_rate_rps=args.workload_rate,
                vocab_size=cfg.vocab_size,
                prompt_len_max=min(40, max(args.cache_len - args.max_new, 4)),
                output_len_max=args.max_new)
            requests = owl.generate(spec)
        else:
            spec = None
            requests = owl.load_trace(args.workload)
        if args.workload_out:
            print("[serve] workload trace ->",
                  owl.save_trace(args.workload_out, requests, spec))
        tenants = sorted({r.tenant for r in requests})
        print(f"[serve] workload: {len(requests)} requests from "
              f"{len(tenants)} tenants "
              f"({', '.join(tenants[:6])}{'…' if len(tenants) > 6 else ''})")
        t0 = time.perf_counter()
        handles = owl.replay(gw, requests, sampling=sampling)
        dt = time.perf_counter() - t0
        return [h for h in handles if h.done], dt
    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(3 + i % 4)]
               for i in range(args.requests)]
    for i, p in enumerate(prompts):
        per_req = SamplingParams(
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            seed=None if args.seed is None else args.seed + i)
        on_token = ((lambda tok, rid=i: print(f"  req{rid} += {tok}"))
                    if args.stream else None)
        gw.submit(p, max_new_tokens=args.max_new,
                  sampling=per_req, on_token=on_token)
    t0 = time.perf_counter()
    done = gw.run()
    return done, time.perf_counter() - t0


# the reference's kernel name, and the port's own, for the paged read
DECODE_KERNEL_NAMES = {"reference": "reference", "pallas": "cuda",
                       "cuda": "cuda"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--policy", default="round-robin",
                    choices=sorted(POLICIES))
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--kv-layout", default="dense",
                    choices=("dense", "paged"),
                    help="decode cache: 'dense' = private per-slot KV "
                    "strips (any arch); 'paged' = block-pool pages with "
                    "radix-tree prefix reuse (pure-attention archs)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV page (paged layout)")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="KV pool size in pages (default 2x slot coverage)")
    ap.add_argument("--decode-kernel", default=None,
                    choices=sorted(DECODE_KERNEL_NAMES),
                    help="paged decode attention read: 'reference' = dense "
                    "block-table gather; 'cuda' (or the reference's name "
                    "'pallas') = the hand-written page-streaming kernel, "
                    "its plain version on the CPU. Default: the engine's "
                    "own (the kernel on the paged layout)")
    ap.add_argument("--fused-tokens", type=int, default=1,
                    help="> 1 runs this many greedy decode steps per "
                    "dispatch on the paged layout (one CUDA graph replay "
                    "on the card: one host round-trip per burst instead "
                    "of per token)")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help=">= 1 enables speculative decoding on the paged "
                    "layout: draft this many tokens per slot, verify all "
                    "of them in one batched forward, roll rejects back at "
                    "block granularity (greedy requests only)")
    ap.add_argument("--drafter", default="ngram",
                    help="draft proposer for --spec-tokens: 'ngram[:n]' "
                    "(self-speculative prompt lookup) or 'model:<arch_id>' "
                    "(small draft LM from the config registry)")
    ap.add_argument("--scheduler", default="phased",
                    choices=("phased", "chunked"),
                    help="prefill interleaving: 'phased' = whole-prompt "
                    "prefill on admission (decode stalls for the prompt "
                    "length); 'chunked' = token-budget scheduler slicing "
                    "prefill into bounded chunks that ride along decode "
                    "dispatches (paged layout only)")
    ap.add_argument("--chunk-budget", type=int, default=32,
                    help="prefill tokens per mixed step for "
                    "--scheduler chunked (the per-step stall bound)")
    ap.add_argument("--admit-budget", type=int, default=None,
                    help="admission control by token budget: total "
                    "prompt+max_new tokens the fleet may have committed at "
                    "once; oversized requests get a 429-style terminal "
                    "stream event instead of a slot")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=None,
                    help="base sampling seed; request i uses seed+i")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they decode")
    ap.add_argument("--journal", default=None,
                    help="optional TaskQueue journal path (durable intake)")
    ap.add_argument("--dashboard", action="store_true",
                    help="print the full queue/slot dashboard after the run")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a span trace of the run and export it as "
                    "Chrome trace events (load the file in "
                    "https://ui.perfetto.dev); exported even when the run "
                    "raises mid-serve")
    ap.add_argument("--workload", default=None, metavar="TRACE.json|synth",
                    help="replace the synthetic prompt batch with a "
                    "multi-tenant workload: a trace file written by "
                    "repro_torch.obs.workload.save_trace, or 'synth' to "
                    "generate one from the default spec (seeded via --seed)")
    ap.add_argument("--workload-duration", type=float, default=2.0,
                    help="generated-workload duration in seconds "
                    "(--workload synth)")
    ap.add_argument("--workload-rate", type=float, default=12.0,
                    help="generated-workload base arrival rate in req/s "
                    "(--workload synth)")
    ap.add_argument("--workload-out", default=None, metavar="TRACE.json",
                    help="export the (generated) workload as a replayable "
                    "trace file")
    ap.add_argument("--slo", default=None, metavar="default|SPECS.json",
                    help="judge every request against per-tier SLO targets: "
                    "'default' for the built-in tier set, or a JSON file "
                    "mapping tier -> {ttft_ms, itl_p95_ms, stall_ms, "
                    "deadline_ms}; prints the SLO dashboard after the run")
    ap.add_argument("--flight-recorder", default=None, nargs="?",
                    const="flightrec", metavar="DIR",
                    help="arm the anomaly flight recorder: on an SLO "
                    "breach, illegal lifecycle transition, replica failure "
                    "or shed spike, dump the span+lifecycle evidence rings "
                    "to DIR/flightrec-*.json (default ./flightrec)")
    ap.add_argument("--probation", type=float, default=None,
                    metavar="SECONDS",
                    help="replica lifecycle recovery: a crashed replica "
                    "rejoins the fleet warm-reset after this probation "
                    "window (default: unhealthy forever)")
    ap.add_argument("--retry-backoff", type=float, default=0.0,
                    metavar="SECONDS",
                    help="base of the per-request exponential backoff "
                    "between crash retries (delay = base * 2**(n-1))")
    ap.add_argument("--brownout", action="store_true",
                    help="arm the graceful-degradation ladder: under "
                    "sustained pressure shed batch-tier intake (503), "
                    "then park the spec/fused fast lanes and cap prefill "
                    "chunks, before premium traffic is ever rejected")
    ap.add_argument("--chaos", default=None, metavar="PLAN",
                    help="arm a deterministic fault schedule against the "
                    "run, e.g. 'crash@d6:r0,straggler@d4-12:r1:2ms,"
                    "pool@s8-40:r0:4,expire@s10' (kinds: crash, "
                    "straggler/slow, pool, nan, expire; d = replica "
                    "dispatch index, s = gateway step index)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed resolving unpinned fault targets in --chaos")
    ap.add_argument("--async-workers", action="store_true",
                    help="run each replica on its own worker thread "
                    "pumping the durable queue (device compute overlaps "
                    "across replicas; step() supervises and waits)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve an OpenMetrics /metrics endpoint (plus "
                    "/series.jsonl and /snapshot.json) on this port for "
                    "the duration of the run; 0 binds an ephemeral port "
                    "(printed). Arms the sampler and utilization ledger")
    ap.add_argument("--series-out", default=None, metavar="OUT.jsonl",
                    help="export the sampled metric time series as JSONL "
                    "(one {name, points} object per series) after the "
                    "run; arms the sampler")
    ap.add_argument("--sample-interval", type=float, default=0.05,
                    metavar="SECONDS",
                    help="continuous-telemetry sampling cadence (default "
                    "0.05 s) — used by --metrics-port / --series-out / "
                    "--watch")
    ap.add_argument("--watch", action="store_true",
                    help="print a live sparkline panel of the headline "
                    "series (queue depth, active slots, pressure gauges) "
                    "while the run drives, and once more at the end")
    ap.add_argument("--ledger", action="store_true",
                    help="arm the per-tenant utilization ledger: each "
                    "engine dispatch's measured step time is split across "
                    "co-batched requests by token share (plus KV "
                    "block-seconds); prints the attribution table after "
                    "the run")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on; 'cpu' runs every "
                    "kernel's plain version (for tests)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[serve] --device cuda, but torch sees no CUDA "
                         "device; pass --device cpu to serve on the CPU")

    if args.trace:
        otrace.enable()

    cfg = registry.get(args.arch, reduced=True)
    if cfg.is_encdec:
        raise SystemExit("serve launcher drives decoder-only archs; "
                         "enc-dec serving goes through serve/step.py")
    params = T.init_lm(torch.Generator(device).manual_seed(0), cfg)
    slo_tiers = None
    if args.slo:
        slo_tiers = (oslo.DEFAULT_TIER_SLOS if args.slo == "default"
                     else oslo.load_slos(args.slo))
    gw = Gateway.build(params, cfg, replicas=args.replicas,
                       batch_slots=args.slots, cache_len=args.cache_len,
                       policy=args.policy, journal_path=args.journal,
                       kv_layout=args.kv_layout, block_size=args.block_size,
                       pool_blocks=args.pool_blocks,
                       decode_kernel=DECODE_KERNEL_NAMES.get(
                           args.decode_kernel),
                       fused_tokens=args.fused_tokens,
                       spec_tokens=args.spec_tokens, drafter=args.drafter,
                       scheduler=args.scheduler,
                       chunk_budget=args.chunk_budget,
                       admit_budget=args.admit_budget,
                       probation_seconds=args.probation,
                       retry_backoff_s=args.retry_backoff,
                       brownout=(BrownoutConfig() if args.brownout
                                 else None),
                       slo=slo_tiers, flight=args.flight_recorder,
                       async_workers=args.async_workers, device=device)
    sampler = mserver = watch_stop = None
    if args.ledger or args.metrics_port is not None:
        gw.arm_ledger()
    if args.metrics_port is not None or args.series_out or args.watch:
        sampler = gw.start_sampler(interval_s=args.sample_interval)
    if args.metrics_port is not None:
        from repro_torch.obs.export import MetricsServer
        mserver = MetricsServer(gw.snapshot, port=args.metrics_port,
                                sampler=sampler, ledger=gw.ledger)
        print(f"[serve] metrics: http://127.0.0.1:{mserver.start()}/metrics "
              "(+ /series.jsonl, /snapshot.json)")
    if args.watch and sampler is not None:
        import threading
        watch_stop = threading.Event()

        def _watch():
            while not watch_stop.wait(0.5):
                panel = reporting.timeseries_panel(sampler)
                if panel:
                    print(panel, flush=True)
        threading.Thread(target=_watch, name="serve-watch",
                         daemon=True).start()
    injector = None
    if args.chaos:
        from repro_torch.chaos import FaultInjector, parse_plan
        plan = parse_plan(args.chaos, seed=args.chaos_seed)
        injector = FaultInjector(plan).arm(gw)
        print(f"[serve] chaos armed: {len(plan.faults)} fault(s), "
              f"seed={plan.seed}")
    try:
        done, dt = _drive(gw, cfg, args)
    except BaseException as err:
        # the crashed run is exactly when the evidence matters: force a
        # flight-recorder dump before the finally-block trace export
        if gw.flight is not None and gw.flight.armed:
            path = gw.flight.trigger("exception", error=repr(err))
            if path is not None:
                print(f"[serve] flight recorder: exception dump -> {path}")
        raise
    finally:
        if watch_stop is not None:
            watch_stop.set()
        if sampler is not None:
            sampler.sample_now()    # final point: short runs still export
        gw.shutdown()               # also stops the sampler thread
        if mserver is not None:
            mserver.stop()
        if args.series_out and sampler is not None:
            print(f"[serve] series: {len(sampler.names())} series, "
                  f"{sampler.samples} samples -> "
                  f"{sampler.export_jsonl(args.series_out)}")
        if args.trace:
            tr = otrace.disable()
            if tr is not None:
                path = tr.export(args.trace)
                print(f"[serve] trace: {tr.recorded} spans recorded "
                      f"({tr.dropped} dropped) -> {path} "
                      f"(load in https://ui.perfetto.dev)")
        if injector is not None:
            injector.disarm()
            by_kind = {}
            for e in injector.fired:
                by_kind[e["fault"]] = by_kind.get(e["fault"], 0) + 1
            print(f"[serve] chaos fired: {by_kind or 'nothing'}")
        if gw.flight is not None:
            fl = gw.flight.stats()
            if fl["dumps"]:
                print(f"[serve] flight recorder: {fl['dumps']} dump(s), "
                      f"last -> {fl['last_dump']}")
            gw.flight.disarm()
    toks = sum(len(r.output) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, {args.replicas}x{args.slots} slots, "
          f"policy={args.policy})")
    for r in done[:4]:
        print(f"  req{r.gid} (replica {r.replica_id}): "
              f"prompt={r.prompt} -> {r.output}")
    s = gw.summary()
    print(f"[serve] ttft p50={_f(s['ttft_p50_ms'])}ms "
          f"p99={_f(s['ttft_p99_ms'])}ms  "
          f"itl p50={_f(s['itl_p50_ms'], '.2f')}ms  "
          f"util={s['mean_slot_utilization']:.2f}")
    kv = gw.kvcache_summary()
    if kv is not None:
        print(f"[serve] kvcache hit_rate={kv['hit_rate']:.2f} "
              f"reused={kv['tokens_reused']} "
              f"computed={kv['tokens_computed']} "
              f"evicted={kv['blocks_evicted']} cow={kv['cow_copies']}")
    spec = gw.spec_summary()
    if spec is not None:
        print(f"[serve] specdec drafter={spec['drafter']} "
              f"acceptance={spec['acceptance_rate']:.2f} "
              f"tok/dispatch={spec['tokens_per_dispatch']:.2f} "
              f"rolled_back={spec['tokens_rolled_back']}")
    sched = gw.scheduler_summary()
    if sched is not None:
        print(f"[serve] scheduler=chunked budget={sched['chunk_budget']} "
              f"chunks={sched['chunks_dispatched']} "
              f"tok/chunk={sched['tokens_per_chunk']:.1f} "
              f"stall p95={_f(s['stall_p95_ms'])}ms")
    if gw.slo is not None:
        print(reporting.slo_dashboard(gw.slo.report()))
    if gw.ledger is not None and gw.ledger.stats() is not None:
        print(reporting.ledger_dashboard(gw.ledger.report()))
    if args.watch and sampler is not None:
        panel = reporting.timeseries_panel(sampler)
        if panel:
            print(panel)
    if args.dashboard:
        print(reporting.unified_dashboard(gw.snapshot(), gw.metrics.gauges))


if __name__ == "__main__":
    main()
