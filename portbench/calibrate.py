"""Readings for a cell's correctness limit, several seeds in one process:
for each seed one run of the cell at its own load (`session.run_cell`,
`--seconds` long enough to finish the mix's longest requests), the
program's widest logit gap against the f32 reference and, with
`--control`, the float8 control's on the same prompts and tokens.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 30 [--control]

Prints one JSON line a seed. The benchmark's runs never run this."""
import argparse
import gc
import json
import sys
import time

import run as entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    entry._environment()
    import torch
    from portbench import session, spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = spec.find_cell(spec.load_benchmark(entry.ROOT), args.workload,
                          entry.ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = session.run_cell(cell, seed, args.seconds, False, "cuda",
                               control=args.control)
        del out["checks"]
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": out["readings"],
                          "metrics": {k: v["value"]
                                      for k, v in out["metrics"].items()},
                          "attempted": out["attempted"],
                          "failed": out["failed"],
                          "peak": out["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
