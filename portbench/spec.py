"""Find what `BENCHMARK.json` names: a cell's configuration, traffic mix,
limits and per-layer metric readers, and the configuration's model side,
each a file of its own under `portbench/`, looked up by name. Adding a
cell, a mix or a metric adds files and entries; no file here changes.
So does a configuration of another model family: its file under
`configs/`, and, where no family there fits, its family module
`families/<name>.py`, which the configuration's `harness_family` names.

A family module defines every function of `FAMILY_FUNCTIONS`:

- `shapes(m)`: {weight name: shape} of the model `m` (a configuration's
  `model` section), and `distribution(name, shape)`: ("normal", std) or
  ("uniform", low, high) of that weight (`weights.make` draws them);
- `program_params(w, m, cfg)`: the program's parameter layout as views
  of those weights (`model.program_params` checks it against the
  program's own shapes);
- `reference_logits(w, m, mix, r, quant=None)`: the plain f32 reference
  (TF32 off) over request `r`'s prompt and served tokens, one row per
  served token; `quant="fp8"` is the control (`check.readings`);
- `decode_flops(m, positions)`, `prefill_flops(m, start, n)` and
  `paged_read_bytes(m, position, block_size)`, this last summed over the
  model's paged-attention layers: the operations and bytes the readers
  count against the peaks in `counts.py`.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FAMILY_FUNCTIONS = ("shapes", "distribution", "program_params",
                    "reference_logits", "decode_flops", "prefill_flops",
                    "paged_read_bytes")


class SpecError(RuntimeError):
    """A name in `BENCHMARK.json` finds no file, or a file is malformed."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<mix>.json
    limits: dict            # limits/<cell>.json
    end_to_end: List[dict]  # BENCHMARK.json metrics this cell reports
    per_layer: List[dict]
    family: ModuleType      # families/<config's harness_family>.py
    root: Path = ROOT


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing {path}")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    names = metric.get("workloads")
    return names is None or cell in names


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` with its files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"{name}: no config {w['config']!r}")
    here = Path(root) / "portbench"
    config_path = Path(root) / configs[w["config"]]["file"]
    config = _json(config_path)
    if "harness_family" not in config:
        raise SpecError(f"{config_path} names no harness_family")
    traffic = _json(here / "traffic" / f"{w['traffic']}.json")
    limits = _json(here / "limits" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                family=family(config["harness_family"], root),
                root=Path(root))


def _module(path: Path, prefix: str, name: str) -> ModuleType:
    mod_name = prefix + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(name: str, root: Path = ROOT) -> ModuleType:
    """The model side `families/<name>.py`, with every function of
    `FAMILY_FUNCTIONS`."""
    path = Path(root) / "portbench" / "families" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no family module {path} for harness_family "
                        f"{name!r}")
    mod = _module(path, "portbench_family_", name)
    missing = [f for f in FAMILY_FUNCTIONS
               if not callable(getattr(mod, f, None))]
    if missing:
        raise SpecError(f"{path} defines no {', '.join(missing)}")
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable[[dict],
                                                             Optional[float]]:
    """`read(record) -> float | None` from `metrics/<name>.py`."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no reader {path} for per-layer metric {name!r}")
    mod = _module(path, "portbench_metric_", name)
    if not callable(getattr(mod, "read", None)):
        raise SpecError(f"{path} defines no read(record)")
    return mod.read


def readers(cell: Cell, root: Path = ROOT) -> Dict[str, Callable]:
    return {m["name"]: metric_reader(m["name"], root) for m in cell.per_layer}
