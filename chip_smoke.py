#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit, no result line):

1. Build: every `src/repro_torch/csrc/*.cu` with nvcc for sm_90a, one
   process per source, all started together (timed as set-up).
2. Kernel against its plain version on the card: the paged-attention
   kernel (flash-decoding: each chain's pages split across blocks by
   `ops.split_plan`, the f32 partials folded in split order by a second
   launch) on the reference's five test shapes and the main path's shape
   (batch 8, 16/8 heads, head_dim 128, 16-token pages, 512-token chains),
   in f32 (TF32 off) and bf16, with empty slots and poisoned pages beyond
   the causal frontier (the output must not move by one bit). Tolerance:
   2e-5 in f32, 2e-2 in bf16 (the JAX reference kernel test's own).
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
   library yardstick, timed here only; the port never calls it). The
   kernel and SDPA are timed two ways: per call from Python (CUDA events
   around a loop of calls, which counts the host's dispatch once it is the
   longer: the `ms` and `library_ms` of the kernels line, as every run has
   reported them) and on the card alone (the calls captured in a CUDA
   graph and replayed: `card_ms` and `library_card_ms`); beside them the
   previous design's times per call (PERF.md's kernel table).
6. Where a greedy batch-8 paged decode step's time goes (torch.profiler),
   with the paged kernel's share (both its launches) of the step.
7. The flash-attention kernel against its plain version: the reference's
   five test shapes, qwen3-1.7b's prefill (B=1, S=256, 16/8 heads, hd 128)
   and recurrentgemma-9b's (B=1, S=2560, 16/1 heads, hd 256, window
   2048); f32 (TF32 off, the CUDA-core template) at 2e-5, bf16 (the
   tensor-core template: mma.sync with cp.async double buffering) at 2e-2.
8. The RG-LRU scan kernel (a chunked scan in one pass: 64-step tiles of
   128 channels, each tile's carry folded from the earlier tiles'
   aggregates in chunk order) against its plain version: the reference's
   three test shapes and recurrentgemma-9b's (1, 2560, 4096); f32 at 1e-4,
   bf16 inputs at 5e-2.
9. Serving on the dense layout: `ServeEngine(kv_layout="dense",
   prefill_mode="bulk", batch_slots=8, cache_len=512)` on qwen3-1.7b with
   attention_impl="pallas", bf16, phase 3's weights and requests. The
   flash kernel must launch 28 x the bulk prefills and the paged kernel
   not at all. Then, in f32, the same engine with "pallas" against "xla"
   in lockstep: prefill and decode logits within 1e-3, a greedy token may
   differ only where the "xla" run's top-2 gap is below that.
10. Serving recurrentgemma-9b at full width (38 layers, d_model 4096, 16/1
   heads, hd 256, lru width 4096, vocab 256000) on the dense layout in
   bf16 with attention_impl="pallas": `batch_slots=4, cache_len=2048`, six
   prompts of 64-512 tokens and one of 2560 (past the 2048 window: the
   ring wraps), 16 new tokens each, one sampled. The scan kernel must
   launch 26 x and the flash kernel 12 x the bulk prefills. A greedy
   batch-4 decode step and the 2,560-token bulk prefill are profiled, with
   the flash kernel's and the scan's shares of the prefill. Then the f32
   check of "pallas" against "xla" at full width, depth cut to one block
   plus the tail (r, r, a, r, r: 5 layers), as in phase 9.
11. Timings of the new kernels at their main-path shapes: kernel, plain
   version, bound (the larger of bytes / 3.35 TB/s and flops / 989 TFLOP/s,
   the H100's dense bf16 tensor rate, for flash; bytes for the scan) and,
   for flash, `scaled_dot_product_attention` (causal with GQA, or an
   explicit window mask; timed here only, the port never calls it); flash
   and SDPA per call from Python and on the card alone, as in phase 5,
   beside the previous design's times; the scan's time per call and on
   the card alone, beside its previous design's (one thread per channel;
   PREVIOUS_SCAN_MS).
12. The SSD chunked-scan kernel against its plain version (the sequential
   recurrence): the reference's four test shapes, a ragged sequence (1,
   1000, 24 heads, hd 64, d_state 128) and mamba2-130m's 2,048-token
   prefill; f32 (TF32 off) at 2e-4, bf16 x/B/C at 5e-2 (the reference
   kernel test's own). Each case logs its route: bf16 tiles the tensor
   cores take run three passes on them (chunk states, carry, output),
   f32 and the rest the first design, on the CUDA cores.
13. Serving mamba2-130m at full width and depth (24 layers, d_model 768,
   24 SSM heads of hd 64, d_state 128, chunk 256, vocab 50280, tied) on
   the dense layout in bf16 with attention_impl="pallas": `batch_slots=8`,
   ten prompts of 64-1,024 tokens (300 and 777 among them: not multiples
   of the chunk, which the reference's Pallas route refuses) and one of
   2,048, 32 new tokens each, one sampled. The SSD kernel must launch 24 x
   the bulk prefills, every call on the tensor-core route, and no other
   kernel at all. A greedy batch-8 decode step and the 2,048-token bulk
   prefill are profiled, with the SSD kernel's share of the prefill. Then,
   in f32 at full depth, "pallas" against "xla" in lockstep, as in phase
   9.
14. Timings of the SSD kernel at the 2,048-token prefill (bf16 x/B/C, f32
   dt): kernel, plain version and bound (the larger of bytes / 3.35 TB/s
   and flops / 989 TFLOP/s, counting the score products over the visible
   pairs of the reference's 256-token chunks), per call and on the card
   alone, beside the first design's (PREVIOUS_SCAN_MS); no single PyTorch
   call computes SSD, so no library time.
15. Fused decode: phase 3's engine with `fused_tokens=8` on phase 3's bf16
   weights and requests. While every live slot is greedy a dispatch is one
   CUDA graph replay of 8 decode steps (captured at the first fused
   dispatch, after two eager warm-up runs that write only the null page);
   the sampled request's batches take single steps. The paged kernel must
   launch exactly 28 x (8 x (replays + warm-up runs) + single dispatches):
   a replay adds the launches its capture recorded. Logs ms per dispatch
   and per decode position beside phase 3's single step, and profiles a
   greedy batch-8 dispatch (device busy share of a replay). Then, in f32
   on phase 4's model, the fused greedy tokens must equal phase 4's
   single-step "cuda" tokens, except after a first divergence at a token
   whose top-2 logit gap in that run is below 1e-3.
16. Speculative decode, `spec_tokens=4`: with the n-gram drafter on phase
   3's bf16 weights and requests (the verify forward is a dense gather, no
   kernel: the paged kernel must launch exactly 28 x the single-step
   dispatches), then in f32 with depth cut to 4 layers, drafting with a
   `ModelDrafter` on the target's own weights: tokens against the single-
   step run under the top-2 rule, acceptance at least 0.9. Logs tokens
   per dispatch, acceptance and rollbacks.
17. Chunked prefill, `scheduler="chunked", chunk_budget=64` on phase 3's
   bf16 weights and requests: the paged kernel (the mixed step's decode
   rows, its second caller) must launch exactly 28 x (mixed + single
   dispatches). Logs ms per mixed dispatch and, with a 256-token prompt
   arriving among 7 decoding requests, the longest gap between two tokens
   of a decoding request, chunked and phased. Then the f32 tokens on phase
   4's model against its single-step run under the top-2 rule.

The last line of stdout is ``{"ok": true, "device": {...}}``; above it
stand the card's name and power limit and one JSON line with each
kernel's numbers (the SSD kernel's launches also by route, the paged
kernel's also by path).
"""
from __future__ import annotations

import json
import re
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
BF16_TENSOR_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# flash attention: the reference's kernel test shapes (tests/test_kernels.py
# FA_CASES, Sq = Sk) and the two main paths': B, S, nh, nkv, hd, window
FLASH_CASES = [
    (2, 64, 4, 2, 32, None),
    (1, 128, 8, 1, 64, 32),
    (2, 32, 4, 4, 64, None),
    (1, 40, 2, 2, 16, None),
    (1, 64, 6, 2, 32, 16),
    (1, 256, 16, 8, 128, None),         # qwen3-1.7b prefill
    (1, 2560, 16, 1, 256, 2048),        # recurrentgemma-9b prefill
]
# RG-LRU scan: the reference's (RGLRU_CASES) and recurrentgemma-9b's: B, S, C
SCAN_CASES = [(2, 32, 64), (1, 100, 130), (2, 16, 16), (1, 2560, 4096)]
# SSD scan: the reference's (tests/test_kernels.py SSD_CASES), a ragged
# sequence and mamba2-130m's 2,048-token prefill: b, s, h, p, g, n, chunk
SSD_CASES = [
    (2, 32, 4, 16, 1, 8, 8),
    (1, 64, 2, 8, 2, 16, 16),
    (2, 16, 4, 32, 1, 32, 16),
    (1, 128, 3, 16, 1, 8, 32),
    (1, 1000, 24, 64, 1, 128, 256),
    (1, 2048, 24, 64, 1, 128, 256),
]
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
LOGIT_TOL = 1e-3
FUSED_TOKENS = 8                   # phase 15's fused dispatch
CHUNK_BUDGET = 64                  # phase 17's chunks
SPEC_F32_LAYERS = 4                # phase 16's f32 check: depth cut to this
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
# the previous design of each attention kernel, per call from Python on an
# H100 80GB HBM3 at 700 W (PERF.md's kernel table), logged beside this
# run's: (kernel ms, SDPA ms)
PREVIOUS_MS = {"paged_attention": (0.1426, 0.0246),
               (1, 256, 16, 8, 128, None): (0.0610, 0.0547),
               (1, 2560, 16, 1, 256, 2048): (2.9387, 0.5069)}
# the previous design of each scan (the RG-LRU walk of one thread per
# channel, the SSD kernel on the CUDA cores), per call from Python and on
# the card alone, on an H100 80GB HBM3 at 700 W (PERF.md's kernel table)
PREVIOUS_SCAN_MS = {"rglru_scan": (0.2711, 0.2701),
                    "ssd_scan": (0.9742, 0.9617)}


def log(msg: str):
    print(msg, flush=True)


def entry_name(mangled: str) -> str:
    """'paged_attention_split<bf16, 128, 2>' from the mangled name of a
    kernel that ptxas reports: the last name of its nested name, then, for
    a template, its dtype and integer arguments."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled
    name = None
    while True:
        found = re.match(r"(\d+)", rest)
        if not found:
            break
        start, end = len(found.group(1)), len(found.group(1)) + int(
            found.group(1))
        name, rest = rest[start:end], rest[end:]
    if name is None:
        return mangled
    found = re.match(r"I((?:13__nv_bfloat16|f)?(?:Li\d+E)*)E", rest)
    if not found:
        return name
    args = found.group(1)
    dtype = ["bf16"] if args.startswith("13__nv_bfloat16") else (
        ["f32"] if args.startswith("f") else [])
    ints = re.findall(r"Li(\d+)E", args)
    return f"{name}<{', '.join(dtype + ints)}>"


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


def flash_inputs(B, S, nh, nkv, hd, dtype, device, seed=SEED):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=device).to(dtype)
                 for shape in ((B, S, nh, hd), (B, S, nkv, hd),
                               (B, S, nkv, hd)))


def check_flash(device) -> dict:
    """Phase 7. Returns the largest error per dtype at recurrentgemma's
    shape (the last case)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            B, S, nh, nkv, hd, window = case
            q, k, v = flash_inputs(B, S, nh, nkv, hd, dtype, device)
            out = flash_attention(q, k, v, window=window)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, window=window).float()
            diff = (out.float() - ref).abs()
            err, tol = diff.max().item(), TOL[dtype]
            bad = (diff > tol + tol * ref.abs()).sum().item()
            if bad or not torch.isfinite(out).all():
                raise AssertionError(f"flash kernel vs plain {dtype} {case}:"
                                     f" max err {err} (tol {tol}), {bad} "
                                     "elements out of tolerance")
            log(f"  flash {str(dtype):14s} B={B} S={S} nh={nh} nkv={nkv} "
                f"hd={hd} window={window}: max abs err {err:.3g} "
                f"(tol {tol})")
            errs[dtype] = err
    return errs


def scan_inputs(B, S, C, dtype, device, seed=SEED):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, S, C), generator=g, device=device))
    b = torch.randn((B, S, C), generator=g, device=device)
    return a.to(dtype), b.to(dtype)


def check_scan(device) -> dict:
    """Phase 8. Returns the largest error per dtype at recurrentgemma's
    shape (the last case)."""
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.rglru_scan.ref import rglru_ref
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in SCAN_CASES:
            a, b = scan_inputs(*case, dtype, device)
            y, h = rglru_scan(a, b)
            torch.cuda.synchronize()
            ref = rglru_ref(a, b)
            diff = (y - ref).abs()
            err, tol = diff.max().item(), SCAN_TOL[dtype]
            bad = (diff > tol + tol * ref.abs()).sum().item()
            if bad or not torch.equal(h, y[:, -1]) \
                    or not torch.isfinite(y).all():
                raise AssertionError(f"scan kernel vs plain {dtype} {case}: "
                                     f"max err {err} (tol {tol}), {bad} "
                                     "elements out of tolerance")
            log(f"  rglru_scan {str(dtype):14s} B,S,C={case}: max abs err "
                f"{err:.3g} (tol {tol})")
            errs[dtype] = err
    return errs


def ssd_inputs(b, s, h, p, g, n, dtype, device, seed=SEED):
    """x, B, C in `dtype`; dt = softplus(N(0,1)) * 0.1 and A = -exp(N(0,1)
    * 0.5) in f32, as the reference's kernel test draws them."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = randn(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(b, s, h)) * 0.1
    A = -torch.exp(randn(h) * 0.5)
    return x, dt, A, randn(b, s, g, n).to(dtype), randn(b, s, g, n).to(dtype)


def check_ssd(device) -> dict:
    """Phase 12. Returns the largest error (y and final state) per dtype at
    mamba2-130m's shape (the last case)."""
    from repro_torch.kernels.ssd_scan.ops import route, ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in SSD_CASES:
            args = ssd_inputs(*case[:6], dtype, device)
            which = route(args[0], args[3], args[4])
            y, st = ssd_scan(*args)
            torch.cuda.synchronize()
            ry, rst = ssd_ref(*args)
            tol, err, bad = SSD_TOL[dtype], 0.0, 0
            for out, ref in ((y.float(), ry), (st, rst)):
                diff = (out - ref).abs()
                err = max(err, diff.max().item())
                bad += (diff > tol + tol * ref.abs()).sum().item()
            if bad or y.dtype != dtype or not torch.isfinite(y).all() \
                    or not torch.isfinite(st).all():
                raise AssertionError(f"ssd kernel vs plain {dtype} {case}: "
                                     f"max err {err} (tol {tol}), {bad} "
                                     "elements out of tolerance")
            log(f"  ssd_scan {str(dtype):14s} b,s,h,p,g,n,chunk={case} "
                f"({which} route): max abs err {err:.3g} (tol {tol})")
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


def time_graph(fn, iters=50, replays=5) -> float:
    """Mean ms per call on the card alone: `iters` calls captured in one
    CUDA graph and replayed, so the host's dispatch stays out of the time
    (a loop of calls from Python measures the host once the kernel is
    shorter than its dispatch)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def time_kernel(device) -> dict:
    """Phase 5 (kernel part): the main-path shape in bf16, every slot at
    the end of a 512-token chain. Six copies of the inputs (>50 MB, the
    L2 size) are cycled so each call finds its pages cold, as each of the
    28 layers does in a decode step."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                         split_plan)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    sets = [paged_case(*MAIN_SHAPE, torch.bfloat16, device, seed=SEED + i)
            for i in range(6)]
    B, nb, bs, nkv, rep, hd, _ = MAIN_SHAPE
    nxt = cycle(sets)
    kernel_ms = time_cuda(lambda: paged_attention(*nxt(), kernel="cuda"))
    kernel_card_ms = time_graph(lambda: paged_attention(*nxt(),
                                                        kernel="cuda"))
    plain_ms = time_cuda(lambda: paged_attention_ref(*nxt()), iters=50)
    # library yardstick: SDPA over the dense view gathered beforehand (the
    # gather is not timed); every slot's chain is full, so no mask
    nxt_d = cycle([dense_view(q, kp, vp, table, MAIN_SHAPE)
                   for q, kp, vp, table, _ in sets])

    def sdpa():
        return F.scaled_dot_product_attention(*nxt_d(), enable_gqa=True)

    library_ms = time_cuda(sdpa)
    library_card_ms = time_graph(sdpa)
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
    return {"ms": kernel_ms, "card_ms": kernel_card_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_card_ms": library_card_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_, "flops": flops,
            "plan": split_plan(B, nkv, nb, bs)[:2]}


def dense_view(q, kp, vp, table, shape):
    """SDPA's inputs for a paged case: q as one query per head, K and V
    gathered from the pool into (B, nkv, nb * bs, hd)."""
    B, nb, bs, nkv, _, hd, _ = shape
    idx = table.long()
    k = kp[idx].reshape(B, nb * bs, nkv, hd).transpose(1, 2).contiguous()
    v = vp[idx].reshape(B, nb * bs, nkv, hd).transpose(1, 2).contiguous()
    return q[:, :, None, :], k, v


def cycle(sets):
    """A function returning the next of `sets` on each call."""
    it = [0]

    def nxt():
        it[0] = (it[0] + 1) % len(sets)
        return sets[it[0]]
    return nxt


def time_flash(device, case) -> dict:
    """Phase 11 (flash): one main-path shape in bf16. Three input sets
    (133 MB at recurrentgemma's shape, above the 50 MB L2) are cycled."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, S, nh, nkv, hd, window = case
    sets = [flash_inputs(B, S, nh, nkv, hd, torch.bfloat16, device,
                         seed=SEED + i) for i in range(3)]
    nxt = cycle(sets)
    kernel_ms = time_cuda(lambda: flash_attention(*nxt(), window=window),
                          iters=50, warmup=5)
    kernel_card_ms = time_graph(
        lambda: flash_attention(*nxt(), window=window), iters=20)
    plain_ms = time_cuda(lambda: attention_ref(*nxt(), window=window),
                         iters=5, warmup=1)
    # library yardstick: SDPA in its (B, heads, S, hd) layout, transposed
    # beforehand (not timed); the window as an explicit boolean mask
    pos = torch.arange(S, device=device)
    visible = pos[None, :] <= pos[:, None]
    if window is not None:
        visible &= pos[None, :] > pos[:, None] - window
    nxt_t = cycle([tuple(t.transpose(1, 2).contiguous() for t in s)
                   for s in sets])
    if window is None:
        def sdpa():
            return F.scaled_dot_product_attention(*nxt_t(), is_causal=True,
                                                  enable_gqa=True)
    else:
        def sdpa():
            return F.scaled_dot_product_attention(*nxt_t(), attn_mask=visible,
                                                  enable_gqa=True)
    library_ms = time_cuda(sdpa, iters=50, warmup=5)
    library_card_ms = time_graph(sdpa, iters=20)
    pairs = int(visible.sum())
    flops = 4 * hd * nh * pairs * B
    bytes_ = sum(t.numel() for t in sets[0]) * 2 + B * S * nh * hd * 2
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_TENSOR_FLOPS * 1e3
    return {"ms": kernel_ms, "card_ms": kernel_card_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_card_ms": library_card_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_, "flops": flops, "pairs": pairs}


def time_scan(device) -> dict:
    """Phase 11 (scan): recurrentgemma's shape (1, 2560, 4096) with f32
    inputs, as the model's gates give them; three input sets (377 MB) are
    cycled."""
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.rglru_scan.ref import rglru_ref
    case = SCAN_CASES[-1]
    sets = [scan_inputs(*case, torch.float32, device, seed=SEED + i)
            for i in range(3)]
    nxt = cycle(sets)
    kernel_ms = time_cuda(lambda: rglru_scan(*nxt()), iters=50, warmup=5)
    kernel_card_ms = time_graph(lambda: rglru_scan(*nxt()), iters=20)
    plain_ms = time_cuda(lambda: rglru_ref(*nxt()), iters=3, warmup=1)
    B, S, C = case
    bytes_ = 3 * B * S * C * 4               # a, b read; y written
    flops = 2 * B * S * C
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return {"ms": kernel_ms, "card_ms": kernel_card_ms, "plain_ms": plain_ms,
            "library_ms": None, "library_card_ms": None,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_, "flops": flops}


def time_ssd(device) -> dict:
    """Phase 14: mamba2-130m's 2,048-token prefill shape, bf16 x/B/C and
    f32 dt as the model hands them over; eight input sets (60 MB, above the
    50 MB L2) are cycled."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    from repro_torch.kernels.ssd_scan.ops import route
    b, s, h, p, g, n, q = SSD_CASES[-1]
    sets = [ssd_inputs(b, s, h, p, g, n, torch.bfloat16, device,
                       seed=SEED + i) for i in range(8)]
    nxt = cycle(sets)
    kernel_ms = time_cuda(lambda: ssd_scan(*nxt()), iters=50, warmup=5)
    kernel_card_ms = time_graph(lambda: ssd_scan(*nxt()), iters=20)
    plain_ms = time_cuda(lambda: ssd_ref(*nxt()), iters=3, warmup=1)
    # inputs read once, y (bf16) and the final state (f32) written once
    bytes_ = (sum(t.numel() * t.element_size() for t in sets[0])
              + b * s * h * p * 2 + b * h * p * n * 4)
    # per (chunk, head) of the reference's chunks: C.B^T and the score
    # product over the visible pairs (i >= j), the carried-state term and
    # the state update
    flops = 0
    for c0 in range(0, s, q):
        m = min(q, s - c0)
        flops += 2 * (m * (m + 1) // 2) * (n + p) + 4 * m * n * p
    flops *= b * h
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_TENSOR_FLOPS * 1e3
    return {"ms": kernel_ms, "card_ms": kernel_card_ms, "plain_ms": plain_ms,
            "library_ms": None, "library_card_ms": None,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_, "flops": flops,
            "route": route(sets[0][0], *sets[0][3:])}


# ----------------------------------------------------------------- serving

def full_config(dtype: str):
    from repro_torch.configs import get
    return get("qwen3-1.7b").replace(dtype=dtype, param_dtype=dtype)


def make_model(cfg, device, seed=SEED):
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=device).manual_seed(seed)
    return T.init_lm(gen, cfg)


def numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(numel(v) for v in tree)
    return tree.numel()


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
    reqs = [engine.submit(p, max_new_tokens=n, sampling=s)
            for p, s, n in requests]
    fns = counters()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    engine.run()
    wall = time.perf_counter() - t0
    launches = fns["paged_attention"].launches
    others = {k: fn.launches for k, fn in fns.items() if fn.launches
              and k != "paged_attention"}
    if others:
        raise AssertionError(f"the paged path launched {others}")
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
    """Make the engine's greedy prefill and decode keep their logits (for
    the NaN checks and the lockstep comparisons): each call appends
    (kind, {request_id: (V,) f32 logits}) for the requests it serves, the
    live slots of a decode step or the slot being prefilled. The greedy
    token is the argmax of the same logits, as in the engine's own greedy
    closures. Returns the list."""
    rec = []

    def wrap(kind, logits_fn):
        def tok_fn(*args):
            logits, cache = logits_fn(*args)
            live = [s for s in range(engine.slots)
                    if engine.active[s] is not None]
            if kind == "prefill":     # the admitted slot has no token yet
                rows = {engine.active[s].request_id:
                        logits.reshape(-1, logits.shape[-1])[0]
                        for s in live if not engine.active[s].output}
            else:
                rows = {engine.active[s].request_id: logits[s] for s in live}
            rec.append((kind, {r: x.float().clone() for r, x in rows.items()}))
            return torch.argmax(logits, dim=-1).to(torch.int32), cache
        return tok_fn

    engine._decode_tok = wrap("decode", engine._decode_lg)
    engine._prefill_tok = wrap("prefill", engine._prefill_lg)
    return rec


def all_finite(rec) -> bool:
    return bool(rec) and all(bool(torch.isfinite(x).all())
                             for _, rows in rec for x in rows.values())


def compare_runs(rec_a, rec_b) -> dict:
    """Two greedy runs of the same traffic in lockstep (same admissions,
    same budgets, so call t of one is call t of the other), `rec_b` the
    oracle: every logits row within LOGIT_TOL, and a greedy token may
    differ only where the oracle's top-2 gap is below LOGIT_TOL (that
    request is compared no further)."""
    if len(rec_a) != len(rec_b):
        raise AssertionError("the two engines ran different step counts")
    max_diff = {"prefill": 0.0, "decode": 0.0}
    diverged, last = {}, 0.0
    for t, ((kind, ra), (kind_b, rb)) in enumerate(zip(rec_a, rec_b)):
        if kind != kind_b or set(ra) != set(rb):
            raise AssertionError(f"call {t}: the runs left lockstep")
        last = 0.0
        for rid, a in ra.items():
            b = rb[rid]
            if not torch.isfinite(a).all():
                raise AssertionError(f"non-finite {kind} logits at call {t}")
            if rid in diverged:
                continue
            d = (a - b).abs().max().item()
            max_diff[kind] = max(max_diff[kind], d)
            last = max(last, d)
            if d > LOGIT_TOL:
                raise AssertionError(f"call {t} ({kind}) request {rid}: "
                                     f"logits differ by {d} > {LOGIT_TOL}")
            if a.argmax() != b.argmax():
                top2 = torch.topk(b, 2).values
                gap = (top2[0] - top2[1]).item()
                if gap >= LOGIT_TOL:
                    raise AssertionError(f"call {t} request {rid}: greedy "
                                         "tokens differ with oracle top-2 "
                                         f"gap {gap}")
                diverged[rid] = (t, gap)
    return {"calls": len(rec_a),
            "steps": sum(k == "decode" for k, _ in rec_a),
            "max_abs_logit_diff": max(max_diff.values()),
            "max_abs_prefill_logit_diff": max_diff["prefill"],
            "max_abs_decode_logit_diff": max_diff["decode"],
            "last_step_max_abs_logit_diff": last,
            "diverged_requests": {str(k): v for k, v in diverged.items()}}


def lockstep(engines, requests) -> dict:
    """Serve the same greedy `requests` through each of `engines` (the
    last is the oracle) with their logits recorded, and compare."""
    recs, outs = [], []
    for eng in engines:
        recs.append(record_logits(eng))
        reqs = [eng.submit(p, max_new_tokens=n) for p, _, n in requests]
        eng.run()
        outs.append([r.output for r in reqs])
    out = compare_runs(*recs)
    out["identical_outputs"] = outs[0] == outs[1]
    out["outs"], out["rec"] = outs[0], recs[0]    # the first engine's run
    return out


def compare_to_oracle(params, cfg, device, requests) -> dict:
    """Phase 4: the same greedy traffic through decode_kernel="cuda" and
    "reference" in lockstep."""
    return lockstep([make_engine(params, cfg, device, kernel)
                     for kernel in ("cuda", "reference")], requests)


# ------------------------------------------------------ dense-layout serving

def counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    return {"paged_attention": paged_attention,
            "flash_attention": flash_attention, "rglru_scan": rglru_scan,
            "ssd_scan": ssd_scan}


def make_dense_engine(params, cfg, device, batch_slots, cache_len):
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(params, cfg, kv_layout="dense", prefill_mode="bulk",
                       batch_slots=batch_slots, cache_len=cache_len,
                       device=device)


def serve_dense(engine, requests, per_prefill: dict) -> dict:
    """Phases 9, 10 and 13's main path: every launch count set to 0 just
    before the run and read just after; kernel k must have launched
    per_prefill[k] x the bulk prefills, every other kernel not at all."""
    reqs = [engine.submit(p, max_new_tokens=n, sampling=s)
            for p, s, n in requests]
    fns = counters()
    torch.cuda.synchronize()
    for fn in fns.values():
        fn.launches = 0
        for route in getattr(fn, "route_launches", {}):
            fn.route_launches[route] = 0
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    routes = {name: dict(fn.route_launches) for name, fn in fns.items()
              if hasattr(fn, "route_launches")}
    cfg = engine.cfg
    for r, (_, _, n) in zip(reqs, requests):
        if r.error is not None or not r.done or len(r.output) != n:
            raise AssertionError(f"request {r.request_id}: done={r.done} "
                                 f"error={r.error!r} tokens={len(r.output)}"
                                 f" of {n}")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.request_id}: token out of "
                                 "the vocabulary")
    decode = engine.step_times["decode"]
    prefill = engine.step_times["prefill"]
    for name, n in launches.items():
        want = per_prefill.get(name, 0) * prefill.n
        if n != want:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{per_prefill.get(name, 0)} x "
                                 f"{prefill.n} bulk prefills = {want}")
    decode_tokens = sum(len(r.output) - 1 for r in reqs)
    return {"requests": len(reqs), "launches": launches,
            "route_launches": routes,
            "prefills": prefill.n, "decode_dispatches": decode.n,
            "prefill_ms_mean": prefill.total / prefill.n,
            "prefill_ms_max": prefill.vmax,
            "decode_step_ms_mean": decode.total / decode.n,
            "decode_tokens_per_s": decode_tokens / (decode.total / 1e3),
            "tokens_per_s": sum(len(r.output) for r in reqs) / wall,
            "wall_s": wall}


def finite_round(engine, requests):
    """A short greedy round outside the counted run, logits recorded: the
    prefill and decode logits must be finite."""
    rec = record_logits(engine)
    for p, _, _ in requests:
        engine.submit(p, max_new_tokens=4)
    engine.run()
    if not all_finite(rec):
        raise AssertionError(f"{engine.cfg.arch_id}: non-finite logits")


def log_profile(prof: dict, what: str = "step"):
    if prof["busy_share"] is None:
        log(f"  {what} {prof['step_ms']:.3f} ms; device time not measured "
            "(the profiler recorded no device events)")
        return
    log(f"  {what} {prof['step_ms']:.3f} ms, device busy "
        f"{prof['device_ms']:.3f} ms ({100 * prof['busy_share']:.1f}%), "
        f"{prof['device_ops_per_step']:.0f} device ops per {what} "
        f"(kernels and copies)")
    for name, ms, count in prof["top"]:
        log(f"    {ms:8.4f} ms/{what}  x{count:<4d} {name}")


def log_share(prof: dict, kernel: str, what: str):
    """The device time of the ops whose name holds `kernel`, per `what` and
    as a share of the device's busy time and of the host-clock time."""
    if prof["busy_share"] is None:
        return
    ms = sum(t for k, t in prof["by_name"].items() if kernel in k)
    log(f"  {kernel}: {ms:.4f} ms per {what}, "
        f"{100 * ms / prof['device_ms']:.1f}% of the device's busy time, "
        f"{100 * ms / prof['step_ms']:.1f}% of the {what}'s "
        f"{prof['step_ms']:.3f} ms")


def log_timing(what: str, t: dict, previous: tuple, library: str):
    """Phases 5 and 11: a kernel's time per call from Python and on the
    card alone, beside the library call's and the previous design's (per
    call, as it was measured)."""
    log(f"  {what}: kernel {t['ms']:.4f} ms per call from Python (previous "
        f"design: {previous[0]:.4f}), {t['card_ms']:.4f} ms on the card "
        f"alone; {library} {t['library_ms']:.4f} ms per call (then: "
        f"{previous[1]:.4f}), {t['library_card_ms']:.4f} ms on the card "
        f"alone; kernel / {library} {t['ms'] / t['library_ms']:.3f} per "
        f"call, {t['card_ms'] / t['library_card_ms']:.3f} on the card")


def log_scan_timing(what: str, t: dict, previous: tuple):
    """Phases 11 and 14: a scan's time per call from Python and on the card
    alone beside the previous design's (PREVIOUS_SCAN_MS), its plain
    version's and its bound; no single PyTorch call computes a scan."""
    log(f"  {what}: kernel {t['ms']:.4f} ms per call from Python (previous "
        f"design: {previous[0]:.4f}), {t['card_ms']:.4f} ms on the card "
        f"alone (previous: {previous[1]:.4f}; {previous[1] / t['card_ms']:.2f}"
        f"x); plain {t['plain_ms']:.4f} ms, no library call, bound "
        f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bytes']} bytes), "
        f"card / bound {t['card_ms'] / t['bound_ms']:.2f}")


def log_served(s: dict):
    log(f"  {s['requests']} requests, {s['prefills']} bulk prefills, "
        f"{s['decode_dispatches']} decode dispatches, launches "
        f"{s['launches']}")
    log(f"  prefill {s['prefill_ms_mean']:.3f} ms mean per request (max "
        f"{s['prefill_ms_max']:.3f}), decode step "
        f"{s['decode_step_ms_mean']:.3f} ms mean, "
        f"{s['decode_tokens_per_s']:.1f} decode tokens/s, "
        f"{s['tokens_per_s']:.1f} tokens/s end to end over "
        f"{s['wall_s']:.3f} s")


def log_lockstep(c: dict):
    log(f"  {c['steps']} lockstep decode steps, max |logit diff| prefill "
        f"{c['max_abs_prefill_logit_diff']:.3g}, decode "
        f"{c['max_abs_decode_logit_diff']:.3g} (tol {LOGIT_TOL}), greedy "
        f"divergences {c['diverged_requests']}, outputs identical: "
        f"{c['identical_outputs']}")


def rgemma_config(dtype: str, **kw):
    from repro_torch.configs import get
    return get("recurrentgemma-9b").replace(dtype=dtype, param_dtype=dtype,
                                            **kw)


def rgemma_requests(cfg, new_tokens=16, seed=SEED):
    """Six prompts of 64-512 tokens and one of 2560 (past the 2048
    window, so the ring wraps); request 2 samples with a seed."""
    from repro_torch.serve.sampler import SamplingParams
    rng = np.random.default_rng(seed)
    lens = list(rng.integers(64, 513, 6)) + [2560]
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).tolist()
               for m in lens]
    sampling = [None] * len(prompts)
    sampling[2] = SamplingParams(temperature=0.8, top_k=50, seed=7)
    return [(p, s, new_tokens) for p, s in zip(prompts, sampling)]


def mamba_config(dtype: str, **kw):
    from repro_torch.configs import get
    return get("mamba2-130m").replace(dtype=dtype, param_dtype=dtype, **kw)


def mamba_requests(cfg, new_tokens=32, seed=SEED):
    """Ten prompts of 64-1,024 tokens, the first two of 300 and 777 (not
    multiples of the 256-token chunk), and one of 2,048; request 4
    samples with a seed."""
    from repro_torch.serve.sampler import SamplingParams
    rng = np.random.default_rng(seed)
    lens = [300, 777] + list(rng.integers(64, 1025, 8)) + [2048]
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).tolist()
               for m in lens]
    sampling = [None] * len(prompts)
    sampling[4] = SamplingParams(temperature=0.8, top_k=50, seed=7)
    return [(p, s, new_tokens) for p, s in zip(prompts, sampling)]


def profile_decode(engine, requests, steps=8) -> dict:
    """Phases 6, 9, 10 and 13: where a decode step's time goes, for a greedy
    batch filling every slot at full width."""
    engine.reset()
    for p, _, n in requests[:engine.slots]:
        # budget for every step below: no slot retires inside the window
        engine.submit(p, max_new_tokens=max(n, 2 * steps + 3))
    engine.step()                  # admission, prefill, first decode
    engine.step()
    return profile_steps(engine.step, steps)


def profile_prefill(engine, prompt, steps=3) -> dict:
    """Phases 10 and 13: where one greedy bulk prefill's time goes. Each step
    admits `prompt` with a budget of one token, so the engine prefills it
    and retires it in the same step, with no decode."""
    engine.reset()

    def prefill():
        engine.submit(prompt, max_new_tokens=1)
        engine.step()
    prefill()                      # warm-up
    return profile_steps(prefill, steps)


def profile_steps(fn, steps) -> dict:
    """Times `steps` calls of `fn` with the host clock, then the same
    number again under torch.profiler for the device-side breakdown (the
    profiler's own host overhead stays out of the step time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
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
                    for e in top],
            "by_name": {e.key: dev_us(e) / 1e3 / steps for e in events}}


# --------------------------------------------- fused, speculative, chunked

def make_variant(params, cfg, device, warm=True, **kw):
    """Phases 15-17's engine: phase 3's, plus one decode variant. With
    `warm`, four greedy requests of 24 new tokens run through it first (the
    fused graph's capture, first calls at new shapes), with no reset after
    them (a reset drops the graph); their step times are cleared."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(params, cfg, kv_layout="paged", decode_kernel="cuda",
                      prefill_mode="bulk", batch_slots=8, cache_len=512,
                      block_size=16, device=device, **kw)
    if warm:
        for p, _, _ in make_requests(cfg, n=4, seed=SEED + 1):
            eng.submit(p, max_new_tokens=24)
        eng.run()
        eng.step_times.clear()
    return eng


def serve_variant(engine, requests) -> dict:
    """Phases 15-17's counted run: every launch count set to 0 just before
    and read just after. The paged kernel must have launched n_layers x
    (fused_tokens x (fused graph replays + its eager warm-up runs) +
    single-token dispatches + mixed dispatches) times, exactly (a replay
    adds the launches its capture recorded; the verify forward has none);
    no other kernel at all. Outputs are checked as in phase 3."""
    reqs = [engine.submit(p, max_new_tokens=n, sampling=s)
            for p, s, n in requests]
    fns = counters()
    graph = engine._decode_fused
    replays0 = graph.replays if graph is not None else 0
    warm0 = graph.warmup_runs if graph is not None else 0
    before = [engine.spec_metrics, engine.scheduler_metrics,
              engine.cache_metrics.as_dict()]
    sync(engine)
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    engine.run()
    sync(engine)
    wall = time.perf_counter() - t0
    cfg = engine.cfg
    for r, (_, _, n) in zip(reqs, requests):
        if r.error is not None or not r.done or len(r.output) != n:
            raise AssertionError(f"request {r.request_id}: done={r.done} "
                                 f"error={r.error!r} tokens={len(r.output)}"
                                 f" of {n}")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.request_id}: token out of "
                                 "the vocabulary")
    kinds = {k: h.n for k, h in engine.step_times.items()}
    replays = (graph.replays - replays0) if graph is not None else 0
    warmups = (graph.warmup_runs - warm0) if graph is not None else 0
    if replays != kinds.get("fused", 0):
        raise AssertionError(f"{kinds.get('fused', 0)} fused dispatches, "
                             f"{replays} graph replays")
    want = cfg.n_layers * (engine.fused_tokens * (replays + warmups)
                           + kinds.get("decode", 0) + kinds.get("mixed", 0))
    launches = {k: fn.launches for k, fn in fns.items()}
    if launches["paged_attention"] != want or any(
            n for k, n in launches.items() if k != "paged_attention"):
        raise AssertionError(
            f"launches {launches}, expected paged_attention {want} = "
            f"{cfg.n_layers} x ({engine.fused_tokens} x ({replays} replays "
            f"+ {warmups} warm-up runs) + {kinds.get('decode', 0)} single "
            f"+ {kinds.get('mixed', 0)} mixed dispatches)")
    times = {k: h.total / h.n for k, h in engine.step_times.items()}
    return {"requests": len(reqs), "launches": launches["paged_attention"],
            "dispatches": kinds, "replays": replays, "warmups": warmups,
            "step_ms_mean": times, "wall_s": wall,
            "tokens_per_s": sum(len(r.output) for r in reqs) / wall,
            "outputs": [r.output for r in reqs],
            "spec": counted(engine.spec_metrics, before[0]),
            "scheduler": counted(engine.scheduler_metrics, before[1]),
            "cache": counted(engine.cache_metrics.as_dict(), before[2])}


def counted(after, before):
    """An engine's counters over one run (the warm-up's taken off), with
    the rates taken again from them."""
    if after is None:
        return None
    out = {k: (v - before[k] if isinstance(v, int) and not isinstance(
        v, bool) and k not in ("spec_tokens", "chunk_budget") else v)
        for k, v in after.items()}
    if "tokens_drafted" in out:
        out["acceptance_rate"] = (out["tokens_accepted"]
                                  / max(out["tokens_drafted"], 1))
        out["tokens_per_dispatch"] = (out["tokens_emitted"]
                                      / max(out["dispatches"], 1))
    if "chunks_dispatched" in out:
        out["tokens_per_chunk"] = (out["prefill_tokens_chunked"]
                                   / max(out["chunks_dispatched"], 1))
    return out


def sync(engine):
    if engine.device.type == "cuda":
        torch.cuda.synchronize()


def log_variant(s: dict):
    log(f"  {s['requests']} requests; dispatches by kind {s['dispatches']}; "
        f"paged kernel launches {s['launches']} (graph replays "
        f"{s['replays']}, warm-up runs {s['warmups']}); step ms mean by kind "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
            s["step_ms_mean"].items()))
        + f"; {s['tokens_per_s']:.1f} tokens/s end to end over "
        f"{s['wall_s']:.3f} s")


def log_spec(spec: dict, cache: dict):
    log(f"  drafter {spec['drafter']}: {spec['dispatches']} verify "
        f"dispatches, {spec['tokens_per_dispatch']:.3f} tokens per dispatch "
        f"(all slots), acceptance {spec['acceptance_rate']:.4f} "
        f"({spec['tokens_accepted']} of {spec['tokens_drafted']} drafts), "
        f"{cache['rollbacks']} rollbacks of {spec['tokens_rolled_back']} "
        "tokens")


def greedy(requests, new_tokens=None):
    return [(p, None, n if new_tokens is None else new_tokens)
            for p, _, n in requests]


def tokens_by_request(rec) -> dict:
    """The logits behind each generated token of a `record_logits` run:
    {request_id: [logits of token 0 (prefill), token 1, ...]}."""
    out = {}
    for _, rows in rec:
        for rid, x in rows.items():
            out.setdefault(rid, []).append(x)
    return out


def match_tokens(outs, ref_outs, ref_rec) -> dict:
    """Phases 15-17's f32 token checks: `outs` must equal `ref_outs` (the
    single-step engine's, whose logits `ref_rec` recorded) request for
    request, except after a first divergence at a token whose logits'
    top-2 gap in the single-step run is below LOGIT_TOL."""
    logits = tokens_by_request(ref_rec)
    diverged = {}
    for rid, (a, b) in enumerate(zip(outs, ref_outs)):
        if a == b:
            continue
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        if t >= len(b) or t >= len(a):
            raise AssertionError(f"request {rid}: {len(a)} tokens against "
                                 f"{len(b)}")
        top2 = torch.topk(logits[rid][t], 2).values
        gap = (top2[0] - top2[1]).item()
        if gap >= LOGIT_TOL:
            raise AssertionError(f"request {rid}: token {t} differs from "
                                 f"the single-step run's with its top-2 "
                                 f"gap {gap}")
        diverged[str(rid)] = (t, gap)
    return {"requests": len(outs), "diverged": diverged,
            "identical": not diverged}


def single_step_reference(params, cfg, device, requests) -> dict:
    """The single-token paged engine's greedy outputs and recorded logits
    for `requests` (phase 16's cut-depth model)."""
    eng = make_engine(params, cfg, device, "cuda")
    rec = record_logits(eng)
    reqs = [eng.submit(p, max_new_tokens=n) for p, _, n in requests]
    eng.run()
    return {"outs": [r.output for r in reqs], "rec": rec}


def profile_fused(engine, requests, steps=3) -> dict:
    """Phase 15: where a greedy batch-8 fused dispatch's time goes (one
    graph replay and the host's reconcile per engine step), every slot
    live with budget enough for every step."""
    engine.reset()
    n = engine.fused_tokens
    for p, _, _ in requests[:engine.slots]:
        engine.submit(p, max_new_tokens=1 + n * (2 + 2 * steps) + n)
    engine.step()                  # admission, prefills, the capture
    engine.step()
    return profile_steps(engine.step, steps)


def stall_gap(engine, requests, long_prompt) -> dict:
    """Phase 17: every slot but one decoding greedily, then `long_prompt`
    arrives. Returns the longest gap between two tokens of one decoding
    request (host clock, from its token of the step before the arrival to
    its token of the step that gives the long request its first token),
    the steps after the arrival, and the long request's wait for its first
    token."""
    engine.reset()
    for p, _, _ in requests[:engine.slots - 1]:
        engine.submit(p, max_new_tokens=64)
    while engine.pending_count() or (engine.scheduler is not None and
                                     engine.scheduler.has_prefill_work()):
        engine.step()
    stamps = {}
    engine.on_token = lambda req, tok: stamps.setdefault(
        req.request_id, []).append(time.perf_counter())
    try:
        engine.step()              # each decoding request's last token before
        longr = engine.submit(long_prompt, max_new_tokens=2)
        t0 = time.perf_counter()
        steps = 0
        while not longr.output:
            engine.step()
            steps += 1
    finally:
        engine.on_token = None
    gaps = [b - a for rid, ts in stamps.items() if rid != longr.request_id
            for a, b in zip(ts, ts[1:])]
    return {"max_gap_ms": max(gaps) * 1e3, "steps": steps,
            "first_token_ms": (stamps[longr.request_id][0] - t0) * 1e3}


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
        entry = name
        for line in text.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                entry = entry_name(found.group(1))
            elif "registers" in line or "spill" in line:
                log(f"  {entry}: {line.strip()}")

    log("[2] kernel against its plain version")
    errs = check_kernel(device)
    log("[7] flash-attention kernel against its plain version")
    flash_errs = check_flash(device)
    log("[8] RG-LRU scan kernel against its plain version")
    scan_errs = check_scan(device)
    log("[12] SSD scan kernel against its plain version")
    ssd_errs = check_ssd(device)

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
    closures = eng._decode_tok, eng._prefill_tok
    finite_round(eng, requests[:8])
    eng._decode_tok, eng._prefill_tok = closures

    log("[6] where a greedy batch-8 decode step's time goes (bf16)")
    prof = profile_decode(eng, requests)
    log_profile(prof)
    log_share(prof, "paged_attention", "step")
    del eng
    torch.cuda.empty_cache()

    log(f"[15] fused decode, fused_tokens={FUSED_TOKENS}, one CUDA graph "
        "replay a dispatch (bf16, phase 3's weights and requests)")
    eng = make_variant(params, cfg, device, fused_tokens=FUSED_TOKENS)
    fused = serve_variant(eng, requests)
    log_variant(fused)
    per_dispatch = fused["step_ms_mean"]["fused"]
    log(f"  {per_dispatch:.3f} ms per fused dispatch, "
        f"{per_dispatch / FUSED_TOKENS:.3f} ms per decode position, beside "
        f"phase 3's single step {served['decode_step_ms_mean']:.3f} ms "
        f"({served['decode_step_ms_mean'] * FUSED_TOKENS / per_dispatch:.2f}"
        "x)")
    log("[15] where a greedy batch-8 fused dispatch's time goes (bf16)")
    prof_f = profile_fused(eng, requests)
    log_profile(prof_f, "dispatch")
    log_share(prof_f, "paged_attention", "dispatch")
    del eng

    log("[16] speculative decode, spec_tokens=4, drafter='ngram' (bf16, "
        "phase 3's weights and requests)")
    eng = make_variant(params, cfg, device, spec_tokens=4, drafter="ngram")
    spec = serve_variant(eng, requests)
    log_variant(spec)
    log_spec(spec["spec"], spec["cache"])
    del eng

    log("[17] chunked prefill, chunk_budget=64 (bf16, phase 3's weights and "
        "requests)")
    eng = make_variant(params, cfg, device, scheduler="chunked",
                       chunk_budget=CHUNK_BUDGET)
    chunked = serve_variant(eng, requests)
    log_variant(chunked)
    log(f"  {chunked['step_ms_mean']['mixed']:.3f} ms per mixed dispatch; "
        f"scheduler {chunked['scheduler']}")
    long_prompt = np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, 256).tolist()
    stall = {"chunked": stall_gap(eng, requests, long_prompt)}
    del eng
    eng = make_engine(params, cfg, device, "cuda")
    stall["phased"] = stall_gap(eng, requests, long_prompt)
    for name, g in stall.items():
        log(f"  {name}: a 256-token prompt arrives among 7 decoding "
            f"requests: longest gap between two tokens of a decoding "
            f"request {g['max_gap_ms']:.3f} ms, {g['steps']} steps to its "
            f"first token ({g['first_token_ms']:.3f} ms)")
    log(f"  (phase 3's bulk prefill: {served['prefill_ms_mean']:.3f} ms mean "
        "per request)")
    del eng
    torch.cuda.empty_cache()

    log("[9] serving qwen3-1.7b on the dense layout, bf16, "
        "attention_impl='pallas' (bulk prefill through the flash kernel)")
    cfg_d = cfg.replace(attention_impl="pallas")
    eng = make_dense_engine(params, cfg_d, device, 8, 512)
    for p, s, n in warm:
        eng.submit(p, max_new_tokens=n, sampling=s)
    eng.run()
    eng.reset()
    eng.step_times.clear()
    dense_q = serve_dense(eng, requests, {"flash_attention": cfg.n_layers})
    log_served(dense_q)
    finite_round(eng, requests[:8])
    log("[9] where a greedy batch-8 dense decode step's time goes (bf16)")
    log_profile(profile_decode(eng, requests))
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
        f"greedy divergences {oracle['diverged_requests']}, outputs "
        f"identical: {oracle['identical_outputs']}")

    f32_requests = make_requests(cfg32, n=8, new_tokens=16)
    log(f"[15] f32 (TF32 off, phase 4's model): fused_tokens={FUSED_TOKENS} "
        "tokens against phase 4's single-step 'cuda' run")
    eng = make_variant(params32, cfg32, device, warm=False,
                       fused_tokens=FUSED_TOKENS)
    fused32 = serve_variant(eng, greedy(f32_requests))
    log_variant(fused32)
    fused_match = match_tokens(fused32["outputs"], oracle["outs"],
                               oracle["rec"])
    log(f"  tokens: {fused_match}")
    del eng
    log("[17] f32 (TF32 off, phase 4's model): chunked, chunk_budget=64, "
        "against phase 4's single-step 'cuda' run")
    eng = make_variant(params32, cfg32, device, warm=False,
                       scheduler="chunked", chunk_budget=CHUNK_BUDGET)
    chunked32 = serve_variant(eng, greedy(f32_requests))
    log_variant(chunked32)
    chunk_match = match_tokens(chunked32["outputs"], oracle["outs"],
                               oracle["rec"])
    log(f"  tokens: {chunk_match}")
    del eng
    cut32 = cfg32.replace(n_layers=SPEC_F32_LAYERS)
    log(f"[16] f32 (TF32 off), depth cut to {cut32.n_layers} layers: "
        "spec_tokens=4 with a ModelDrafter on the target's own weights, "
        "against the single-step 'cuda' run")
    p_cut = make_model(cut32, device)
    spec_requests = greedy(f32_requests[:4])
    ref = single_step_reference(p_cut, cut32, device, spec_requests)
    from repro_torch.serve.draft import ModelDrafter
    eng = make_variant(p_cut, cut32, device, warm=False, spec_tokens=4,
                       drafter=ModelDrafter(p_cut, cut32, cache_len=512))
    spec32 = serve_variant(eng, spec_requests)
    log_variant(spec32)
    log_spec(spec32["spec"], spec32["cache"])
    spec_match = match_tokens(spec32["outputs"], ref["outs"], ref["rec"])
    log(f"  tokens: {spec_match}")
    if spec32["spec"]["acceptance_rate"] < 0.9:
        raise AssertionError(f"self-drafting acceptance "
                             f"{spec32['spec']['acceptance_rate']} < 0.9")
    del eng, p_cut, ref

    log("[9] dense qwen3-1.7b at full width, f32: 'pallas' against 'xla'")
    dense_q32 = lockstep(
        [make_dense_engine(params32, cfg32.replace(attention_impl=impl),
                           device, 8, 512) for impl in ("pallas", "xla")],
        make_requests(cfg32, n=8, new_tokens=16))
    log_lockstep(dense_q32)
    del params32
    torch.cuda.empty_cache()

    log("[5] timings at the main path's shape (bf16, B=8, 16/8 heads, "
        "hd 128, 16-token pages, 512-token chains)")
    timing = time_kernel(device)
    log_timing("paged_attention", timing, PREVIOUS_MS["paged_attention"],
               "SDPA on the dense view")
    log(f"  plain version {timing['plain_ms']:.4f} ms, bound "
        f"{timing['bound_ms']:.4f} ms by {timing['bound_by']} "
        f"({timing['bytes']} bytes, {timing['flops']} flops)")
    log(f"  split plan {timing['plan'][0]} splits of {timing['plan'][1]} "
        "pages")

    log("[10] serving recurrentgemma-9b at full width on the dense layout, "
        "bf16, attention_impl='pallas'")
    cfg_r = rgemma_config("bfloat16", attention_impl="pallas")
    t0 = time.perf_counter()
    params = make_model(cfg_r, device)
    n_params = numel(params)
    log(f"  {n_params / 1e9:.3f} B parameters made in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    eng = make_dense_engine(params, cfg_r, device, 4, 2048)
    for p, s, n in rgemma_requests(cfg_r, new_tokens=2, seed=SEED + 1)[:4]:
        eng.submit(p, max_new_tokens=n, sampling=s)
    eng.run()
    eng.reset()
    eng.step_times.clear()
    r_requests = rgemma_requests(cfg_r)
    n_attn = cfg_r.layer_types().count("attn")
    dense_r = serve_dense(eng, r_requests, {
        "rglru_scan": cfg_r.n_layers - n_attn, "flash_attention": n_attn})
    log_served(dense_r)
    finite_round(eng, r_requests[-2:])
    log("[10] where a greedy batch-4 decode step's time goes (bf16)")
    log_profile(profile_decode(eng, r_requests))
    log(f"[10] where a greedy bulk prefill of {len(r_requests[-1][0])} "
        "tokens goes (bf16)")
    prof = profile_prefill(eng, r_requests[-1][0])
    log_profile(prof, "prefill")
    log_share(prof, "flash_attention", "prefill")
    log_share(prof, "rglru_scan", "prefill")
    del eng, params
    torch.cuda.empty_cache()

    cut = rgemma_config("float32", n_layers=5)
    log(f"[10] recurrentgemma-9b at full width, f32, depth cut to "
        f"{cut.n_layers} layers {cut.layer_types()}: 'pallas' against "
        "'xla'")
    params32 = make_model(cut, device)
    r32 = [(p, None, 8) for p, _, _ in rgemma_requests(cut)[-3:]]
    dense_r32 = lockstep(
        [make_dense_engine(params32, cut.replace(attention_impl=impl),
                           device, 4, 2048) for impl in ("pallas", "xla")],
        r32)
    log_lockstep(dense_r32)
    del params32
    torch.cuda.empty_cache()

    log("[11] timings of the new kernels at their main-path shapes (bf16 "
        "flash, f32 scan)")
    flash_t = {}
    for case in FLASH_CASES[-2:]:
        t = flash_t[case] = time_flash(device, case)
        log_timing(f"flash B,S,nh,nkv,hd,window={case}", t, PREVIOUS_MS[case],
                   "SDPA")
        log(f"  plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"by {t['bound_by']} ({t['flops']} flops over {t['pairs']} "
            f"visible pairs at {BF16_TENSOR_FLOPS / 1e12:.0f} TFLOP/s, "
            f"{t['bytes']} bytes)")
    scan_t = time_scan(device)
    log_scan_timing(f"rglru_scan B,S,C={SCAN_CASES[-1]}", scan_t,
                    PREVIOUS_SCAN_MS["rglru_scan"])
    flash_main = flash_t[FLASH_CASES[-1]]

    log("[13] serving mamba2-130m at full width on the dense layout, bf16, "
        "attention_impl='pallas'")
    cfg_m = mamba_config("bfloat16", attention_impl="pallas")
    params = make_model(cfg_m, device)
    log(f"  {numel(params) / 1e6:.1f} M parameters (padded vocab "
        f"{cfg_m.padded_vocab_size}; {cfg_m.param_count() / 1e6:.1f} M as "
        "the config counts them)")
    eng = make_dense_engine(params, cfg_m, device, 8, 4096)
    for p, s, n in mamba_requests(cfg_m, new_tokens=2, seed=SEED + 1)[:4]:
        eng.submit(p, max_new_tokens=n, sampling=s)
    eng.run()
    eng.reset()
    eng.step_times.clear()
    m_requests = mamba_requests(cfg_m)
    dense_m = serve_dense(eng, m_requests, {"ssd_scan": cfg_m.n_layers})
    log_served(dense_m)
    if dense_m["route_launches"]["ssd_scan"]["simt"]:
        raise AssertionError("a bf16 SSD call of the served prefills left the "
                             f"tensor-core route: "
                             f"{dense_m['route_launches']['ssd_scan']}")
    finite_round(eng, m_requests[-2:])
    log("[13] where a greedy batch-8 decode step's time goes (bf16)")
    log_profile(profile_decode(eng, m_requests))
    log(f"[13] where a greedy bulk prefill of {len(m_requests[-1][0])} "
        "tokens goes (bf16)")
    prof = profile_prefill(eng, m_requests[-1][0])
    log_profile(prof, "prefill")
    log_share(prof, "ssd_scan", "prefill")
    del eng, params
    torch.cuda.empty_cache()

    cfg_m32 = mamba_config("float32")
    log("[13] mamba2-130m at full width and depth, f32: 'pallas' against "
        "'xla'")
    params32 = make_model(cfg_m32, device)
    picked = mamba_requests(cfg_m32)
    m32 = [(p, None, 8) for p, _, _ in picked[:3] + picked[-1:]]
    dense_m32 = lockstep(
        [make_dense_engine(params32, cfg_m32.replace(attention_impl=impl),
                           device, 8, 4096) for impl in ("pallas", "xla")],
        m32)
    log_lockstep(dense_m32)
    del params32
    torch.cuda.empty_cache()

    log("[14] SSD kernel timings at mamba2-130m's 2,048-token prefill")
    ssd_t = time_ssd(device)
    log_scan_timing(f"ssd_scan b,s,h,p,g,n,chunk={SSD_CASES[-1]}", ssd_t,
                    PREVIOUS_SCAN_MS["ssd_scan"])
    log(f"  ({ssd_t['flops']} flops at {BF16_TENSOR_FLOPS / 1e12:.0f} "
        f"TFLOP/s; the {ssd_t['route']} route)")

    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:43",
        "launches": served["launches"],
        "max_abs_err": errs[torch.bfloat16],
        "launches_by_path": {"single": served["launches"],
                             "fused": fused["launches"],
                             "speculative": spec["launches"],
                             "chunked": chunked["launches"]},
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "card_ms": timing["card_ms"],
        "library_card_ms": timing["library_card_ms"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "launches": (dense_q["launches"]["flash_attention"]
                     + dense_r["launches"]["flash_attention"]),
        "max_abs_err": flash_errs[torch.bfloat16],
        "ms": flash_main["ms"], "plain_ms": flash_main["plain_ms"],
        "bound_ms": flash_main["bound_ms"],
        "bound_by": flash_main["bound_by"],
        "library_ms": flash_main["library_ms"],
        "card_ms": flash_main["card_ms"],
        "library_card_ms": flash_main["library_card_ms"],
    }, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:25",
        "launches": dense_r["launches"]["rglru_scan"],
        "max_abs_err": scan_errs[torch.bfloat16],
        "ms": scan_t["ms"], "plain_ms": scan_t["plain_ms"],
        "bound_ms": scan_t["bound_ms"], "bound_by": scan_t["bound_by"],
        "library_ms": None, "card_ms": scan_t["card_ms"],
        "library_card_ms": None,
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:24",
        "launches": dense_m["launches"]["ssd_scan"],
        "route_launches": dense_m["route_launches"]["ssd_scan"],
        "max_abs_err": ssd_errs[torch.bfloat16],
        "ms": ssd_t["ms"], "plain_ms": ssd_t["plain_ms"],
        "bound_ms": ssd_t["bound_ms"], "bound_by": ssd_t["bound_by"],
        "library_ms": None, "card_ms": ssd_t["card_ms"],
        "library_card_ms": None,
    }]
    log(f"kernels: paged_attention launches={served['launches']} "
        f"(decode dispatches {served['decode_dispatches']} x "
        f"{cfg.n_layers} layers); f32 max abs err "
        f"{errs[torch.float32]:.3g}, bf16 {errs[torch.bfloat16]:.3g}; on "
        f"the fused path {fused['launches']} ({fused['replays']} replays, "
        f"{fused['warmups']} warm-up runs of {FUSED_TOKENS} steps, "
        f"{fused['dispatches'].get('decode', 0)} single dispatches), the "
        f"speculative {spec['launches']} "
        f"({spec['dispatches'].get('decode', 0)} single dispatches; the "
        f"verify has none), the chunked {chunked['launches']} "
        f"({chunked['dispatches'].get('mixed', 0)} mixed + "
        f"{chunked['dispatches'].get('decode', 0)} single dispatches)")
    log(f"kernels: flash_attention launches="
        f"{kernels[1]['launches']} (qwen3 {dense_q['prefills']} prefills x "
        f"{cfg.n_layers} layers + recurrentgemma {dense_r['prefills']} "
        f"prefills x {n_attn} layers); f32 max abs err "
        f"{flash_errs[torch.float32]:.3g}, bf16 "
        f"{flash_errs[torch.bfloat16]:.3g}")
    log(f"kernels: rglru_scan launches={kernels[2]['launches']} "
        f"({dense_r['prefills']} prefills x {cfg_r.n_layers - n_attn} "
        f"layers); "
        f"f32 max abs err {scan_errs[torch.float32]:.3g}, bf16 "
        f"{scan_errs[torch.bfloat16]:.3g}")
    log(f"kernels: ssd_scan launches={kernels[3]['launches']} "
        f"({dense_m['prefills']} prefills x {cfg_m.n_layers} layers; by "
        f"route {kernels[3]['route_launches']}); f32 "
        f"max abs err {ssd_errs[torch.float32]:.3g}, bf16 "
        f"{ssd_errs[torch.bfloat16]:.3g}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
