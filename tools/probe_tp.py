#!/usr/bin/env python3
"""chip_smoke.py's tensor-parallel phases (29-31, 33-37) driven alone on
one card, with `--dp` phase 32 (the MoE load balance on a data-parallel
mesh under remat), and phases 35-37 (the serving steps tensor parallel,
`chip_smoke.serve_tp_phases`; 37 the recurrent families):

    python3 tools/probe_tp.py [--phases 29,30,31,33,34,35,36,37] [--dp]
                              [--out FILE]

Builds the kernels (the "pallas" forward runs the flash kernel on each
rank's heads, the RG-LRU scan on its channels and SSD on its SSM heads),
then runs `chip_smoke.family_tp_phases` (each phase's
unsharded baseline in this process and its two tensor-parallel ranks,
processes on the one card over gloo, with chip_smoke.py's checks and log
lines); `--out` writes the results as JSON. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="29,30,31,33,34")
    ap.add_argument("--dp", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_tp: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.card_line()
    C.log(f"card: {card}; torch {torch.__version__}")
    t0 = time.perf_counter()
    build.build()
    C.log(f"build {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda")
    phases = [int(p) for p in args.phases.split(",") if p]
    out = {"card": card, **C.family_tp_phases(
        device, card, [p for p in phases if p not in C.SERVE_TP_ARCHS])}
    serving = [p for p in phases if p in C.SERVE_TP_ARCHS]
    if serving:
        out["serving"] = C.serve_tp_phases(device, card, serving)
    if args.dp:
        out[32] = C.dp_phase(device, card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
