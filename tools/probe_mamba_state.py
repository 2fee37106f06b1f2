#!/usr/bin/env python3
"""Run chip_smoke.py's phase 39 alone: the Mamba2 decode state step kernel
(csrc/mamba_state.cu) against its plain version at docqa's decode shape
(granite-4.0-h-small's 128 heads of 64 x 128 over 64 slots, every slot
live and every other slot dead), with its timings beside the bound and the
plain version; with --serve also phase 40 (granite-4.0-h-small served on
the paged fused path, every kernel's launches counted).

    python3 tools/probe_mamba_state.py [--serve]   # from the repository root

Prints the card line and one JSON line of the timings and errors (and of
phase 40's launch counts)."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_mamba_state: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    logs = build.build(None if "--serve" in sys.argv[1:] else
                       ["mamba_state"])
    for line in logs.get("mamba_state", "").splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
    print(chip_smoke.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False     # as chip_smoke.main
    torch.backends.cudnn.allow_tf32 = False
    out = chip_smoke.mamba_state_phase(torch.device("cuda"))
    print(json.dumps(out), flush=True)
    if "--serve" in sys.argv[1:]:
        s = chip_smoke.hybrid_phase(torch.device("cuda"))
        print(json.dumps({k: s[k] for k in (
            "mamba_launches", "ssd_launches", "moe_launches", "launches",
            "replays", "warmups", "dispatches", "step_ms_mean",
            "tokens_per_s")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
