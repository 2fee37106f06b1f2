#!/usr/bin/env python3
"""Run chip_smoke.py's phase 38 alone: the grouped MoE experts kernel
(csrc/moe_experts.cu) against its plain version at the benchmark cells'
decode shapes, granite-moe-1b-a400m's and the batch of 8 rows in bf16, and
at 8 rows in f32, with its timings beside the bound and the plain version.

    python3 tools/probe_moe_experts.py      # from the repository root

Prints the card line and one JSON line of the timings and errors."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_moe_experts: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    build.build(["moe_experts"])
    print(chip_smoke.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False     # as chip_smoke.main
    torch.backends.cudnn.allow_tf32 = False
    out = chip_smoke.moe_experts_phase(torch.device("cuda"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
