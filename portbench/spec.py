"""Find what `BENCHMARK.json` names: a cell's configuration, traffic mix,
limits and per-layer metric readers, each a file of its own under
`portbench/`, looked up by name. Adding a cell, a mix or a metric adds
files and entries; no file here changes."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


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
    config = _json(Path(root) / configs[w["config"]]["file"])
    traffic = _json(here / "traffic" / f"{w['traffic']}.json")
    limits = _json(here / "limits" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)], root=Path(root))


def metric_reader(name: str, root: Path = ROOT) -> Callable[[dict],
                                                             Optional[float]]:
    """`read(record) -> float | None` from `metrics/<name>.py`."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no reader {path} for per-layer metric {name!r}")
    mod_name = "portbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise SpecError(f"{path} defines no read(record)")
    return mod.read


def readers(cell: Cell, root: Path = ROOT) -> Dict[str, Callable]:
    return {m["name"]: metric_reader(m["name"], root) for m in cell.per_layer}
