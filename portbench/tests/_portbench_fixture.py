"""A tiny cell for the CPU tests: its configuration, traffic mix and
limits as new files in a copy of `portbench/`, and a BENCHMARK.json that
names them beside the real cells."""
import hashlib
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELL = "tiny.cell"


def tiny_model(moe: bool = True) -> dict:
    m = {"arch_id": "tiny", "family": "moe" if moe else "dense",
         "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 0 if moe else 96, "vocab_size": 512,
         "tie_embeddings": moe, "act": "silu", "rope_theta": 10000.0,
         "norm_eps": 1e-6, "dtype": "float32", "param_dtype": "float32"}
    if moe:
        m["moe"] = {"n_experts": 4, "top_k": 2, "expert_d_ff": 32,
                    "capacity_factor": 1.25}
    return m


def tiny_mix(shared: bool = False) -> dict:
    mix = {"clients": 4, "slots": 4, "cache_len": 128,
           "block_size": 16, "fused_tokens": 8, "scheduler": "phased",
           "prefill_mode": "bulk", "sizes_seed": 1, "sizes_block": 8,
           "prompt": {"median": 24, "sigma": 0.5, "min": 16, "max": 48},
           "output": {"median": 20, "sigma": 0.5, "min": 12, "max": 30}}
    if shared:
        del mix["prompt"]
        mix["shared"] = {"documents": 3,
                         "doc": {"median": 40, "sigma": 0.4, "min": 20,
                                 "max": 60},
                         "question": {"min": 4, "max": 12}}
    return mix


def make_root(tmp: Path, moe: bool = True, shared: bool = False,
              metric_src: str = None, family: str = "decoder") -> Path:
    """A checkout-like root in `tmp`: a copy of portbench/ with the tiny
    cell's files added, and BENCHMARK.json naming them. With
    `metric_src`, a new per-layer metric `tiny.counted` read by it; the
    tiny configuration's model side is `families/<family>.py`."""
    root = Path(tmp) / "root"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = root / "portbench"
    (pb / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "model": tiny_model(moe), "reduced": [],
         "harness_family": family}))
    (pb / "traffic" / "tiny.json").write_text(json.dumps(tiny_mix(shared)))
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"max_logit_gap": {"limit": 1e-3}, "sample_tokens": 150,
         "sample_requests": 8}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test fixture",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "CPU test"})
    bench["workloads"].append({"name": CELL, "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    if metric_src is not None:
        (pb / "metrics" / "tiny.counted.py").write_text(metric_src)
        bench["per_layer"].append({
            "name": "tiny.counted", "unit": "count", "better": "higher",
            "source": "program_span", "layer": "engine",
            "moves": "output_tokens_per_s", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def tree_hashes(path: Path) -> dict:
    """{relative path: sha256} of every file under `path`."""
    return {p.relative_to(path).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(path.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def tiny_cell(tmp: Path, **kw):
    from portbench import spec
    root = make_root(tmp, **kw)
    return spec.find_cell(spec.load_benchmark(root), CELL, root)
