#!/usr/bin/env python3
"""Sweep the two scan kernels' tile lengths on one NVIDIA GPU: the
measurements behind the chunk each wrapper keeps (`ssd_scan.ops.MMA_CHUNK`,
`rglru_scan.ops.CHUNK`), which chip_smoke.py does not repeat on every run.

    python3 tools/probe_scans.py

Measured, each on the card alone (a CUDA graph of 20 calls replayed,
chip_smoke.time_graph) and per call from Python (CUDA events around a loop
of calls, chip_smoke.time_cuda), with the inputs cycled so that each call
finds them cold in the 50 MB L2, as chip_smoke.py's phases 11 and 14 do:

* the SSD scan's tensor-core route at mamba2-130m's 2,048-token prefill
  (1, 2048, 24 heads, hd 64, g 1, d_state 128; bf16 x, B, C, f32 dt) at
  chunks of 64, 128 and 256 tokens, each with its largest error against
  the plain version (y and the final state) and the largest ratio of an
  error to the tolerance 5e-2 + 5e-2 |ref|; the same with x, B and C as
  views of one (1, 2048, 1,792) tensor, as the model hands them over; and
  the CUDA-core route (the first design) on the same bf16 inputs;
* the RG-LRU scan at recurrentgemma-9b's (1, 2560, 4096) with f32 inputs
  at tiles of 32, 64 and 128 steps, each with its largest error against
  the plain version.

Prints one line per measurement, the card's name and power limit, and,
last, one JSON object.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402  (helpers: inputs, timers)

SSD_SHAPE = smoke.SSD_CASES[-1][:6]       # b, s, h, p, g, n
SCAN_SHAPE = smoke.SCAN_CASES[-1]         # B, S, C
SSD_CHUNKS = (64, 128, 256)
SCAN_CHUNKS = (32, 64, 128)
TOL = 5e-2


def xbc_views(x, B, C):
    """x, B and C copied into one (b, s, h p + 2 g n) tensor and returned
    as views of it, as `mamba2_forward` slices xBC."""
    b, s, h, p = x.shape
    g, n = B.shape[2:]
    xBC = torch.cat([x.reshape(b, s, h * p), B.reshape(b, s, g * n),
                     C.reshape(b, s, g * n)], dim=-1)
    return (xBC[..., :h * p].reshape(b, s, h, p),
            xBC[..., h * p:h * p + g * n].reshape(b, s, g, n),
            xBC[..., h * p + g * n:].reshape(b, s, g, n))


def errors(out, ref) -> tuple:
    """(largest |error|, largest |error| / (TOL + TOL |ref|)) over y and
    the final state."""
    err = ratio = 0.0
    for o, r in zip(out, ref):
        d = (o.float() - r).abs()
        err = max(err, d.max().item())
        ratio = max(ratio, (d / (TOL + TOL * r.abs())).max().item())
    return err, ratio


def timed(fn, iters=20) -> dict:
    return {"card_ms": smoke.time_graph(fn, iters=iters),
            "ms": smoke.time_cuda(fn, iters=50, warmup=5)}


def probe_ssd(device) -> dict:
    from repro_torch.kernels.ssd_scan import kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    sets = [smoke.ssd_inputs(*SSD_SHAPE, torch.bfloat16, device,
                             seed=smoke.SEED + i) for i in range(8)]
    ref = ssd_ref(*sets[0])
    views = []
    for x, dt, A, B, C in sets:
        xv, Bv, Cv = xbc_views(x, B, C)
        views.append((xv, dt, A, Bv, Cv))
    nxt, nxt_v = smoke.cycle(sets), smoke.cycle(views)
    out = {}
    for q in SSD_CHUNKS:
        err, ratio = errors(kernel.ssd_scan_mma_kernel(*sets[0], q), ref)
        row = timed(lambda: kernel.ssd_scan_mma_kernel(*nxt(), q))
        row["xbc_card_ms"] = smoke.time_graph(
            lambda: kernel.ssd_scan_mma_kernel(*nxt_v(), q), iters=20)
        row.update(max_abs_err=err, worst_tol_ratio=ratio)
        out[f"mma_q{q}"] = row
    err, ratio = errors(kernel.ssd_scan_kernel(*sets[0]), ref)
    row = timed(lambda: kernel.ssd_scan_kernel(*nxt()))
    row.update(max_abs_err=err, worst_tol_ratio=ratio)
    out["simt"] = row
    return out


def probe_rglru(device) -> dict:
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_kernel
    from repro_torch.kernels.rglru_scan.ref import rglru_ref
    sets = [smoke.scan_inputs(*SCAN_SHAPE, torch.float32, device,
                              seed=smoke.SEED + i) for i in range(3)]
    ref = rglru_ref(*sets[0])
    nxt = smoke.cycle(sets)
    out = {}
    for t in SCAN_CHUNKS:
        y = rglru_scan_kernel(*sets[0], t)
        row = timed(lambda: rglru_scan_kernel(*nxt(), t))
        row["max_abs_err"] = (y - ref).abs().max().item()
        out[f"t{t}"] = row
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_scans: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    build.build(["ssd_scan", "rglru_scan"])
    device = torch.device("cuda")
    card = smoke.card_line()
    result = {"card": card, "ssd": probe_ssd(device),
              "rglru": probe_rglru(device)}
    for name, row in result["ssd"].items():
        extra = (f", xBC views {row['xbc_card_ms']:.4f} ms on the card"
                 if "xbc_card_ms" in row else "")
        print(f"ssd {name} {SSD_SHAPE}: {row['card_ms']:.4f} ms on the card "
              f"alone, {row['ms']:.4f} ms per call{extra}; max abs err "
              f"{row['max_abs_err']:.4g}, worst err / tol "
              f"{row['worst_tol_ratio']:.3f}", flush=True)
    for name, row in result["rglru"].items():
        print(f"rglru {name} {SCAN_SHAPE}: {row['card_ms']:.4f} ms on the "
              f"card alone, {row['ms']:.4f} ms per call; max abs err "
              f"{row['max_abs_err']:.3g}", flush=True)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
