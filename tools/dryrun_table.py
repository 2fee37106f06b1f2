#!/usr/bin/env python3
"""The dry-run's records of the archs tensor parallel over "model" (by
default the five dense decoders; `--archs` names others) on the
reference's four meshes, for train_4k or the shapes `--shapes` names
(the serving shapes prefill_32k, decode_32k, long_500k), run through the
dry-run CLI in parallel processes, as one table: per-device flops (and
times the ranks), all-reduces, all-gathers and all-to-alls, collective
bytes and the per-rank peak.

    python3 tools/dryrun_table.py [--src DIR] [--jobs 8] [--archs A,B]
                                  [--shapes S,T] [--out FILE]

`--src` runs another checkout's package (its `src/`; for a parent
against change comparison unpack the parent with `git archive` into the
git-ignored `build/`). Each case runs as rank 0 of a fake process group
on the host (nothing is allocated on a device): the numbers are the
port's model of the reference's meshes, not device times. Full configs:
run it where the host has the memory and the cores (each case is one
process with one torch thread). Prints a Markdown table; `--out` writes
every record as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-1.7b", "qwen3-4b", "mistral-nemo-12b", "starcoder2-7b",
         "pixtral-12b")
MESHES = {"(2, 2)": ["--debug-mesh"],
          "(2, 2, 2)": ["--debug-mesh", "--multi-pod-only"],
          "(16, 16)": [],
          "(2, 16, 16)": ["--multi-pod-only"]}
CASE_TIMEOUT_S = 1800


def launch(src: Path, arch: str, shape: str, mesh: str, out: Path):
    env = {**os.environ, "PYTHONPATH": str(src / "src"),
           "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, *MESHES[mesh], "--out", str(out)]
    log = open(out / "log.txt", "w")
    return subprocess.Popen(cmd, cwd=src, env=env, stdout=log,
                            stderr=subprocess.STDOUT), log


def run_all(src: Path, jobs: int, archs=ARCHS, shapes=("train_4k",)) -> list:
    """Every (arch, shape, mesh) case, `jobs` at a time; a record per case
    ({"error": its log's tail} where it failed)."""
    cases = [(a, sh, m) for a in archs for sh in shapes for m in MESHES]
    tmp = Path(tempfile.mkdtemp(prefix="dryrun_table_"))
    pending, running, done = list(cases), {}, {}
    while pending or running:
        while pending and len(running) < jobs:
            arch, shape, mesh = pending.pop(0)
            out = tmp / f"{arch}_{len(done) + len(running)}"
            out.mkdir()
            proc, log = launch(src, arch, shape, mesh, out)
            running[(arch, shape, mesh)] = (proc, log, out, time.monotonic())
        time.sleep(1.0)
        for key, (proc, log, out, t0) in list(running.items()):
            late = time.monotonic() - t0 > CASE_TIMEOUT_S
            if proc.poll() is None and not late:
                continue
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            del running[key]
            files = sorted(out.glob("*.json"))
            if proc.returncode == 0 and files:
                done[key] = json.loads(files[0].read_text())
            else:
                done[key] = {"error": (out / "log.txt").read_text()[-1500:]}
    return [dict(done[c], case_arch=c[0], case_shape=c[1], case_mesh=c[2])
            for c in cases]


def row(rec: dict) -> str:
    if "error" in rec:
        return (f"| {rec['case_arch']} | {rec['case_shape']} | "
                f"{rec['case_mesh']} | failed: "
                f"{(rec['error'].strip().splitlines() or ['-'])[-1][:80]} |")
    n = rec["n_devices"]
    c = rec["collectives"]
    tp = rec.get("tensor_parallel")
    mar = rec.get("model_axis_all_reduces") or {}
    return (f"| {rec['arch']} | {rec['shape']} | {rec['case_mesh']} | "
            f"{'-' if tp is None else tp} | "
            f"{rec['flops_per_device']:.4e} | "
            f"{rec['flops_per_device'] * n:.4e} | "
            f"{c['all-reduce']['count']} ({mar.get('count', 0)}) | "
            f"{c['all-gather']['count']} | "
            f"{c['all-to-all']['count']} | "
            f"{rec['collective_bytes_per_device'] / 2**30:.3f} | "
            f"{rec['memory']['peak_bytes'] / 2**30:.2f} | "
            f"{len(rec.get('gathered_leaves', []))} | {rec['run_s']} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT),
                    help="checkout whose src/ runs (default: this one)")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--archs", default=",".join(ARCHS),
                    help="comma-separated arch ids")
    ap.add_argument("--shapes", default="train_4k",
                    help="comma-separated shapes")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    t0 = time.perf_counter()
    recs = run_all(src, args.jobs, tuple(args.archs.split(",")),
                   tuple(args.shapes.split(",")))
    print(f"dry-run {args.shapes} from {src} "
          f"({time.perf_counter() - t0:.1f} s)")
    print("| arch | shape | mesh | tensor parallel | flops/device | "
          "flops/device x ranks | all-reduces (model axis) | all-gathers | "
          "all-to-alls | collective GiB/device | peak GiB/rank | gathered "
          "leaves | run s |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|---|")
    for rec in recs:
        print(row(rec))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(recs, indent=1))
    return 1 if any("error" in r for r in recs) else 0


if __name__ == "__main__":
    raise SystemExit(main())
