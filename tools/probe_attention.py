#!/usr/bin/env python3
"""Probe the two attention kernels' wrappers and the paged kernel's split
plan on one NVIDIA GPU: measurements that chip_smoke.py does not repeat on
every run.

    python3 tools/probe_attention.py [--src DIR] [--sweep]

`--src` names the `src` directory of the tree whose `repro_torch` is
probed (default: this checkout's), so that two commits can be compared in
one call: unpack the other into a git-ignored directory and run parent,
change, change, parent. Each tree builds its own kernels into its own
`build/`. Prints one line per measurement and, last, one JSON object.

Measured, all at bf16:

* host time per call: `n` calls of a wrapper on one input set timed on the
  host's clock, first to the end of the loop (what the host spends issuing
  a call, while the card keeps up), then to the end of a synchronize: the
  paged wrapper at chip_smoke.py's MAIN_SHAPE (batch 8, 16/8 heads, hd 128,
  16-token pages, 512-token chains) and SDPA over its dense view; the flash
  wrapper at qwen3-1.7b's prefill (1, 256, 16/8 heads, hd 128) and causal
  SDPA with GQA there. The paged wrapper's host time is split by timing
  its launcher alone (`kernel.paged_attention_kernel`, no argument checks)
  and its C entry point alone (ctypes, arguments computed beforehand).
* with `--sweep` (trees whose paged wrapper plans splits): the paged kernel
  on the card alone (CUDA-graph replay, chip_smoke.time_graph) at the plan's
  split and at 7 and 8 pages per split, and the kernel and SDPA at twice the
  chain (1,024 tokens), which with the main shape's times splits a call
  into a fixed cost and a cost per byte.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (helpers: inputs, timers)

# MAIN_SHAPE with twice the chain
LONG_SHAPE = (8, 64, 16, 8, 2, 128, (1024,) * 8)
FLASH_SHAPE = (1, 256, 16, 8, 128)


def host_ms(fn, n: int) -> tuple:
    """(ms per call to the end of the loop, ms per call to the end of a
    synchronize after it), over n calls after 50 warm-up calls."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / n * 1e3, (t2 - t0) / n * 1e3


def probe_host(device, n: int) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    args = smoke.paged_case(*smoke.MAIN_SHAPE, torch.bfloat16, device)
    dense = smoke.dense_view(*args[:4], smoke.MAIN_SHAPE)
    q, k, v = smoke.flash_inputs(*FLASH_SHAPE, torch.bfloat16, device)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return paged_parts(args, n) | {
        "paged_attention": host_ms(
            lambda: paged_attention(*args, kernel="cuda"), n),
        "sdpa_dense_view": host_ms(
            lambda: F.scaled_dot_product_attention(*dense, enable_gqa=True),
            n),
        "flash_attention": host_ms(lambda: flash_attention(q, k, v), n),
        "sdpa_causal": host_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), n),
    }


def paged_parts(args, n: int) -> dict:
    """Host time of the paged launcher alone and of its C entry point alone
    (in trees with and without the split plan)."""
    from repro_torch.kernels.paged_attention import kernel as paged_kernel
    from repro_torch.kernels.paged_attention import ops
    q, kp, vp, table, pos = args
    B, nh, hd = q.shape
    P, bs, nkv, _ = kp.shape
    nb = table.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    fn = paged_kernel._entry_points()[0][q.dtype]
    ptrs = [t.data_ptr() for t in (q, kp, vp, table, pos, out)]
    if hasattr(ops, "split_plan"):
        ns, pps = ops.split_plan(B, nkv, nb, bs)[:2]
        kw = {"n_splits": ns, "pages_per_split": pps}
        n_acc = B * nh * ns * hd
        scratch = torch.empty(n_acc + B * nh * ns * 2, device=q.device)
        acc = scratch.data_ptr()
        c_args = (*ptrs, acc, acc + 4 * n_acc, B, nh, nkv, hd, bs, nb, P, ns,
                  pps, hd ** -0.5, stream)
    else:
        kw = {}
        c_args = (*ptrs, B, nh, nkv, hd, bs, nb, P, hd ** -0.5, stream)
    launch = paged_kernel.paged_attention_kernel
    return {
        "paged_launcher_alone": host_ms(
            lambda: launch(*args, scale=hd ** -0.5, **kw), n),
        "paged_c_entry_alone": host_ms(lambda: fn(*c_args), n)}


def probe_sweep(device) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_kernel
    from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                         split_plan)
    B, nb, bs, nkv, _, hd, _ = smoke.MAIN_SHAPE
    nxt = smoke.cycle([smoke.paged_case(*smoke.MAIN_SHAPE, torch.bfloat16,
                                        device, seed=smoke.SEED + i)
                       for i in range(6)])
    plan = split_plan(B, nkv, nb, bs)
    splits = {}
    for pps in sorted({plan.pages_per_split, 7, 8}):
        n = -(-nb // pps)
        splits[pps] = (n, smoke.time_graph(lambda: paged_attention_kernel(
            *nxt(), scale=hd ** -0.5, n_splits=n, pages_per_split=pps)))
    out = {"plan": list(plan[:2]), "by_pages_per_split": splits}
    for name, shape in (("main", smoke.MAIN_SHAPE), ("long", LONG_SHAPE)):
        sets = [smoke.paged_case(*shape, torch.bfloat16, device,
                                 seed=smoke.SEED + i) for i in range(4)]
        nxt = smoke.cycle(sets)
        nxt_d = smoke.cycle([smoke.dense_view(*s[:4], shape) for s in sets])
        out[name] = {
            "kernel_card_ms": smoke.time_graph(
                lambda: paged_attention(*nxt(), kernel="cuda")),
            "sdpa_card_ms": smoke.time_graph(
                lambda: F.scaled_dot_product_attention(*nxt_d(),
                                                       enable_gqa=True))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is probed")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--sweep", action="store_true",
                    help="also time the paged split plans and 1,024-token "
                         "chains on the card alone")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_attention: torch sees no CUDA device", file=sys.stderr)
        return 1
    src = Path(a.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build
    build.build(["paged_attention", "flash_attention"])
    device = torch.device("cuda")
    card = smoke.card_line()
    result = {"src": str(src.relative_to(ROOT)) if src.is_relative_to(ROOT)
              else src.name, "card": card,
              "host": probe_host(device, a.iters)}
    for name, (loop, synced) in result["host"].items():
        print(f"{name}: {loop:.4f} ms per call issued, {synced:.4f} ms per "
              f"call to the synchronize ({a.iters} calls)", flush=True)
    if a.sweep:
        result["sweep"] = sw = probe_sweep(device)
        print(f"split plan {sw['plan']}; on the card alone by pages per "
              "split: " + ", ".join(f"{pps} ({n} splits) {ms:.4f} ms"
                                    for pps, (n, ms)
                                    in sw["by_pages_per_split"].items()))
        for name in ("main", "long"):
            print(f"{name} chains on the card alone: kernel "
                  f"{sw[name]['kernel_card_ms']:.4f} ms, SDPA "
                  f"{sw[name]['sdpa_card_ms']:.4f} ms")
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
