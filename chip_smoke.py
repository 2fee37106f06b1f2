#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit, no result line):

1. Build: every `src/repro_torch/csrc/*.cu` with nvcc for sm_90a, one
   process per source, all started together (timed as set-up).
2. Kernel against its plain version on the card: the paged-attention
   kernel on the reference's five test shapes and the main path's shape
   (batch 8, 16/8 heads, head_dim 128, 16-token pages, 512-token chains),
   in f32 (TF32 off) and bf16, with empty slots and poisoned pages beyond
   the causal frontier. Tolerance: 2e-5 in f32, 2e-2 in bf16 (the JAX
   reference kernel test's own).
3. Serving, the main path: `ServeEngine(kv_layout="paged",
   decode_kernel="cuda", prefill_mode="bulk")` on qwen3-1.7b at full width
   (28 layers, d_model 2048, 16/8 heads, head_dim 128, d_ff 6144, vocab
   151936, tied) in bf16, random weights from a seeded CUDA generator,
   serving 10 requests of 64-256 prompt tokens and 32 new tokens each: two
   share a prefix (radix reuse with copy-on-write), one samples with a
   seed. The kernel's launch count is reset just before and read just
   after: it must equal 28 x the decode dispatches.
4. The kernel against the dense-gather oracle at full width in f32: the
   same model served by decode_kernel="cuda" and "reference" in lockstep.
   Logits agree within 1e-3 (absolute) at every step; a greedy token may
   differ only where the oracle's top-2 logit gap is below that tolerance.
5. Timings at the main path's shape: the kernel, its plain version, the
   bound (bytes it must move / 3.35 TB/s, the H100's memory rate) and
   `scaled_dot_product_attention` over the pre-gathered dense view (a
   library yardstick, timed here only; the port never calls it).

The last line of stdout is ``{"ok": true, "device": {...}}``; above it
stand the card's name and power limit and one JSON line with each
kernel's numbers.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_FLOPS = 67e12                  # H100 SXM f32, outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LOGIT_TOL = 1e-3
# the reference's kernel test shapes (tests/test_paged_attention_kernel.py)
# and the main path's: B, nb, bs, nkv, rep, hd, tokens resident per slot
KERNEL_CASES = [
    (2, 4, 8, 2, 2, 32, (32, 32)),
    (2, 4, 8, 4, 1, 32, (32, 19)),
    (3, 4, 8, 1, 4, 64, (9, 1, 27)),
    (4, 3, 16, 2, 2, 32, (17, 0, 48, 0)),
    (1, 6, 8, 2, 3, 16, (41,)),
    (8, 32, 16, 8, 2, 128, (512, 300, 1, 0, 17, 256, 511, 64)),
]
MAIN_SHAPE = (8, 32, 16, 8, 2, 128, (512,) * 8)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- kernels

def paged_case(B, nb, bs, nkv, rep, hd, fills, dtype, device, seed=SEED):
    """Kernel inputs: slot b holds fills[b] tokens (0 = empty slot, all-
    null table) in shuffled pool rows, plus one allocated-but-unwritten
    page past its frontier where the table has room (as the engine
    reserves a request's budget); pos[b] = fills[b] - 1."""
    g = torch.Generator(device=device).manual_seed(seed)
    P = B * nb + 1
    kpool = torch.randn((P, bs, nkv, hd), generator=g, device=device)
    vpool = torch.randn((P, bs, nkv, hd), generator=g, device=device)
    q = torch.randn((B, nkv * rep, hd), generator=g, device=device)
    rows = (torch.randperm(P - 1, generator=g, device=device) + 1).tolist()
    table = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    for b in range(B):
        if fills[b] > 0:
            need = min(-(-fills[b] // bs) + 1, nb)
            table[b, :need] = [rows.pop() for _ in range(need)]
        pos[b] = max(fills[b] - 1, 0)
    return (q.to(dtype), kpool.to(dtype), vpool.to(dtype),
            torch.as_tensor(table, device=device),
            torch.as_tensor(pos, device=device))


def attendable_rows(table, pos, fills, P, bs):
    """(P, bs) bool: the pool rows some slot may attend (its pages up to
    and including position pos[b]); every other row is fair game for
    poison."""
    keep = torch.zeros((P, bs), dtype=torch.bool)
    tbl, ps = table.cpu().tolist(), pos.cpu().tolist()
    for b, f in enumerate(fills):
        if f == 0:
            continue
        p = ps[b]
        for j in range(p // bs):
            keep[tbl[b][j]] = True
        keep[tbl[b][p // bs], :p % bs + 1] = True
    return keep.to(table.device)


def check_kernel(device) -> dict:
    """Phase 2. Returns the largest error per dtype at the main shape."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in KERNEL_CASES:
            q, kp, vp, table, pos = paged_case(*case, dtype, device)
            out = paged_attention(q, kp, vp, table, pos, kernel="cuda")
            torch.cuda.synchronize()
            ref = paged_attention_ref(q, kp, vp, table, pos)
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[dtype]
            bad = ((out.float() - ref.float()).abs()
                   > tol + tol * ref.float().abs()).sum().item()
            empty = [b for b, f in enumerate(case[6]) if f == 0]
            if bad or not torch.isfinite(out).all() or any(
                    out[b].abs().max().item() != 0 for b in empty):
                raise AssertionError(f"kernel vs plain {dtype} {case[:6]}: "
                                     f"max err {err} (tol {tol}), {bad} "
                                     "elements out of tolerance")
            # poison every pool row no slot may attend (pages past each
            # frontier, the rest of each frontier page, unused rows): the
            # output must not move by one bit
            keep = attendable_rows(table, pos, case[6], kp.shape[0], case[2])
            kp2 = kp.masked_fill(~keep[:, :, None, None], 1e4)
            vp2 = vp.masked_fill(~keep[:, :, None, None], -1e4)
            out2 = paged_attention(q, kp2, vp2, table, pos, kernel="cuda")
            if not torch.equal(out, out2):
                raise AssertionError(f"poison past the frontier leaked: "
                                     f"{dtype} {case[:6]}")
            log(f"  kernel {str(dtype):14s} B={case[0]} nb={case[1]} "
                f"bs={case[2]} nkv={case[3]} rep={case[4]} hd={case[5]}: "
                f"max abs err {err:.3g} (tol {tol})")
            if case == KERNEL_CASES[-1]:
                errs[dtype] = err
    return errs


def time_cuda(fn, iters=200, warmup=20) -> float:
    """Mean ms per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernel(device) -> dict:
    """Phase 5 (kernel part): the main-path shape in bf16, every slot at
    the end of a 512-token chain. Six copies of the inputs (>50 MB, the
    L2 size) are cycled so each call finds its pages cold, as each of the
    28 layers does in a decode step."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    sets = [paged_case(*MAIN_SHAPE, torch.bfloat16, device, seed=SEED + i)
            for i in range(6)]
    B, nb, bs, nkv, rep, hd, _ = MAIN_SHAPE
    it = [0]

    def nxt():
        it[0] = (it[0] + 1) % len(sets)
        return sets[it[0]]

    kernel_ms = time_cuda(lambda: paged_attention(*nxt(), kernel="cuda"))
    plain_ms = time_cuda(lambda: paged_attention_ref(*nxt()), iters=50)
    # library yardstick: SDPA over the dense view gathered beforehand (the
    # gather is not timed); every slot's chain is full, so no mask
    dense = []
    for q, kp, vp, table, _ in sets:
        idx = table.long()
        k = kp[idx].reshape(B, nb * bs, nkv, hd).transpose(1, 2).contiguous()
        v = vp[idx].reshape(B, nb * bs, nkv, hd).transpose(1, 2).contiguous()
        dense.append((q[:, :, None, :], k, v))
    it[0] = 0

    def sdpa():
        it[0] = (it[0] + 1) % len(dense)
        q, k, v = dense[it[0]]
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)

    library_ms = time_cuda(sdpa)
    # the bound, from what this data needs: q, the K/V rows up to each
    # slot's position, the table and positions, and the output
    q, kp, vp, table, pos = sets[0]
    elt = q.element_size()
    tokens = int((pos.long() + 1).sum())
    bytes_ = (2 * q.numel() * elt + 2 * tokens * nkv * hd * elt
              + table.numel() * 4 + pos.numel() * 4)
    flops = 4 * tokens * nkv * rep * hd
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_, "flops": flops}


# ----------------------------------------------------------------- serving

def full_config(dtype: str):
    from repro_torch.configs import get
    return get("qwen3-1.7b").replace(dtype=dtype, param_dtype=dtype)


def make_model(cfg, device, seed=SEED):
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=device).manual_seed(seed)
    return T.init_lm(gen, cfg)


def make_requests(cfg, n=10, new_tokens=32, seed=SEED):
    """(prompt, sampling) pairs: prompts of 64-256 tokens; requests 0 and 1
    share their first 150 tokens (a partial page at 16-token pages, so the
    second admission copies a page on write); request 3 samples."""
    from repro_torch.serve.sampler import SamplingParams
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 257, n)
    if n > 1:
        lens[0], lens[1] = 200, 180
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).tolist() for m in lens]
    if n > 1:
        prompts[1] = prompts[0][:150] + prompts[1][150:]
    sampling = [None] * n
    if n > 3:
        sampling[3] = SamplingParams(temperature=0.8, top_k=50, seed=7)
    return [(p, s, new_tokens) for p, s in zip(prompts, sampling)]


def make_engine(params, cfg, device, decode_kernel, batch_slots=8):
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(params, cfg, kv_layout="paged",
                       decode_kernel=decode_kernel, prefill_mode="bulk",
                       batch_slots=batch_slots, cache_len=512,
                       block_size=16, device=device)


def serve(engine, requests) -> dict:
    """Phase 3's main path: admit, prefill, decode to the end. Returns what
    the checks and the timings need."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    reqs = [engine.submit(p, max_new_tokens=n, sampling=s)
            for p, s, n in requests]
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    paged_attention.launches = 0
    t0 = time.perf_counter()
    engine.run()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    cfg = engine.cfg
    for r, (p, _, n) in zip(reqs, requests):
        if r.error is not None or not r.done or len(r.output) != n:
            raise AssertionError(f"request {r.request_id}: done={r.done} "
                                 f"error={r.error!r} tokens={len(r.output)}"
                                 f" of {n}")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.request_id}: token out of "
                                 "the vocabulary")
    decode = engine.step_times["decode"]
    prefill = engine.step_times["prefill"]
    if launches != cfg.n_layers * decode.n:
        raise AssertionError(f"kernel launches {launches} != {cfg.n_layers} "
                             f"layers x {decode.n} decode dispatches")
    m = engine.cache_metrics
    if m.hits < 1 or m.cow_copies < 1:
        raise AssertionError(f"radix reuse did not run: {m.as_dict()}")
    decode_tokens = sum(len(r.output) - 1 for r in reqs)
    return {"requests": len(reqs), "launches": launches,
            "decode_dispatches": decode.n,
            "decode_step_ms_mean": decode.total / decode.n,
            "decode_step_ms_p50": decode.percentile(50),
            "prefill_ms_mean": prefill.total / prefill.n,
            "decode_tokens_per_s": decode_tokens / (decode.total / 1e3),
            "tokens_per_s": sum(len(r.output) for r in reqs) / wall,
            "wall_s": wall, "cache": m.as_dict(),
            "outputs": [r.output for r in reqs]}


def record_logits(engine) -> list:
    """Make the engine's greedy decode keep every step's logits (for the
    oracle comparison); returns the list it appends (B, V) f32 copies to."""
    from repro_torch.serve.step import build_decode_paged
    rec = []
    lg = build_decode_paged(engine.cfg, return_logits=True,
                            kernel=engine.decode_kernel)

    def decode_tok(params, tokens, pos, cache, table):
        logits, cache = lg(params, tokens, pos, cache, table)
        rec.append(logits.float().clone())
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    engine._decode_tok = decode_tok
    return rec


def compare_to_oracle(params, cfg, device, requests) -> dict:
    """Phase 4: the same greedy traffic through decode_kernel="cuda" and
    "reference" in lockstep (same admissions, same budgets, so step t of
    one is step t of the other)."""
    recs, outs = {}, {}
    for kernel in ("cuda", "reference"):
        eng = make_engine(params, cfg, device, kernel)
        recs[kernel] = record_logits(eng)
        reqs = [eng.submit(p, max_new_tokens=n) for p, _, n in requests]
        eng.run()
        outs[kernel] = [r.output for r in reqs]
        del eng
    if len(recs["cuda"]) != len(recs["reference"]):
        raise AssertionError("the two engines ran different step counts")
    max_diff, diverged, last = 0.0, {}, 0.0
    for t, (a, b) in enumerate(zip(recs["cuda"], recs["reference"])):
        live = [s for s in range(a.shape[0]) if s not in diverged]
        diff = (a[live] - b[live]).abs().amax(dim=-1)
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite logits at decode step {t}")
        max_diff = max(max_diff, diff.max().item())
        last = diff.max().item()
        if diff.max().item() > LOGIT_TOL:
            raise AssertionError(f"step {t}: logits differ by "
                                 f"{diff.max().item()} > {LOGIT_TOL}")
        ta, tb = a.argmax(-1), b.argmax(-1)
        for s in live:
            if ta[s] != tb[s]:
                top2 = torch.topk(b[s], 2).values
                gap = (top2[0] - top2[1]).item()
                if gap >= LOGIT_TOL:
                    raise AssertionError(f"step {t} slot {s}: greedy tokens "
                                         f"differ with oracle top-2 gap {gap}")
                diverged[s] = (t, gap)
    return {"steps": len(recs["cuda"]), "max_abs_logit_diff": max_diff,
            "last_step_max_abs_logit_diff": last,
            "diverged_slots": {str(k): v for k, v in diverged.items()},
            "identical_outputs": outs["cuda"] == outs["reference"]}


def profile_decode(engine, requests, steps=8) -> dict:
    """Phase 6: where a decode step's time goes, for a greedy batch of 8
    at full width. Times `steps` steps with the host clock, then the same
    number again under torch.profiler for the device-side breakdown (the
    profiler's own host overhead stays out of the step time)."""
    from torch.profiler import ProfilerActivity, profile
    engine.reset()
    for p, _, n in requests[:engine.slots]:
        engine.submit(p, max_new_tokens=n)
    engine.step()                  # admission, prefill, first decode
    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, copies): a CPU op's self device
    # time repeats the time of the kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda and dev_us(e) > 0]
    device_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    top = sorted(events, key=dev_us, reverse=True)[:8]
    return {"step_ms": step_ms, "device_ms": device_ms,
            "busy_share": device_ms / step_ms if events else None,
            "device_ops_per_step": sum(e.count for e in events) / steps,
            "top": [(e.key[:60], dev_us(e) / 1e3 / steps, e.count // steps)
                    for e in top]}


# ----------------------------------------------------------------- main

def main(device: str = "cuda") -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs only "
              "on a GPU", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no {SRC / 'repro_torch'}; run it from the "
              "repository root", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    logs = build.build()
    log(f"[1] build: {len(logs)} source(s) compiled in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[2] kernel against its plain version")
    errs = check_kernel(device)

    log("[3] serving qwen3-1.7b at full width, bf16")
    cfg = full_config("bfloat16")
    params = make_model(cfg, device)
    eng = make_engine(params, cfg, device, "cuda")
    warm = make_requests(cfg, n=4, new_tokens=4, seed=SEED + 1)
    for p, s, n in warm:               # first calls: cuBLAS set-up etc.
        eng.submit(p, max_new_tokens=n, sampling=s)
    eng.run()
    eng.reset()
    eng.step_times.clear()
    requests = make_requests(cfg)
    served = serve(eng, requests)
    log(f"  {served['requests']} requests, {served['decode_dispatches']} "
        f"decode dispatches, {served['launches']} kernel launches, cache "
        f"hits {served['cache']['hits']}, CoW copies "
        f"{served['cache']['cow_copies']}, tokens reused "
        f"{served['cache']['tokens_reused']}")
    log(f"  decode step {served['decode_step_ms_mean']:.3f} ms mean "
        f"(p50 <= {served['decode_step_ms_p50']:.1f} ms, a histogram "
        f"bucket bound), "
        f"{served['decode_tokens_per_s']:.1f} decode tokens/s, prefill "
        f"{served['prefill_ms_mean']:.3f} ms mean, "
        f"{served['tokens_per_s']:.1f} tokens/s end to end over "
        f"{served['wall_s']:.3f} s")
    # NaN check outside the counted run: a second, short round (which also
    # reuses the first round's cached prefixes) with its logits recorded
    eng_decode_tok = eng._decode_tok
    rec = record_logits(eng)
    for p, _, _ in requests[:8]:
        eng.submit(p, max_new_tokens=4)
    eng.run()
    if not rec or not all(bool(torch.isfinite(x).all()) for x in rec):
        raise AssertionError("bf16 decode produced non-finite logits")
    del rec
    eng._decode_tok = eng_decode_tok

    log("[6] where a greedy batch-8 decode step's time goes (bf16)")
    prof = profile_decode(eng, requests)
    if prof["busy_share"] is None:
        log(f"  step {prof['step_ms']:.3f} ms; device time not measured "
            "(the profiler recorded no device events)")
    else:
        log(f"  step {prof['step_ms']:.3f} ms, device busy "
            f"{prof['device_ms']:.3f} ms ({100 * prof['busy_share']:.1f}%), "
            f"{prof['device_ops_per_step']:.0f} device ops per step "
            f"(kernels and copies)")
        for name, ms, count in prof["top"]:
            log(f"    {ms:8.4f} ms/step  x{count:<4d} {name}")
    del eng, params
    torch.cuda.empty_cache()

    log("[4] kernel against the dense-gather oracle at full width, f32")
    cfg32 = full_config("float32")
    params32 = make_model(cfg32, device)
    oracle = compare_to_oracle(params32, cfg32, device,
                               make_requests(cfg32, n=8, new_tokens=16))
    log(f"  {oracle['steps']} lockstep steps, max |logit diff| "
        f"{oracle['max_abs_logit_diff']:.3g} (last step "
        f"{oracle['last_step_max_abs_logit_diff']:.3g}, tol {LOGIT_TOL}), "
        f"greedy divergences {oracle['diverged_slots']}, outputs identical: "
        f"{oracle['identical_outputs']}")
    del params32
    torch.cuda.empty_cache()

    log("[5] timings at the main path's shape (bf16, B=8, 16/8 heads, "
        "hd 128, 16-token pages, 512-token chains)")
    timing = time_kernel(device)
    log(f"  kernel {timing['ms']:.4f} ms, plain version "
        f"{timing['plain_ms']:.4f} ms, SDPA on the dense view "
        f"{timing['library_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
        f"by {timing['bound_by']} ({timing['bytes']} bytes, "
        f"{timing['flops']} flops)")

    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:43",
        "launches": served["launches"],
        "max_abs_err": errs[torch.bfloat16],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]
    log(f"kernels: paged_attention launches={served['launches']} "
        f"(decode dispatches {served['decode_dispatches']} x "
        f"{cfg.n_layers} layers); f32 max abs err "
        f"{errs[torch.float32]:.3g}, bf16 {errs[torch.bfloat16]:.3g}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
