"""The harness finds what BENCHMARK.json names by name, the file keeps to
the benchmark's contract, and a cell, a mix and a metric are taken as new
files alone."""
import json
import math
import re

import pytest
import torch

from _portbench_fixture import CELL, ROOT, make_root, tiny_cell, tree_hashes
from portbench import session, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    c = spec.find_cell(BENCH, cell)
    assert c.config["model"]["n_layers"] > 0
    assert c.traffic["clients"] >= 1
    assert "max_logit_gap" in c.limits
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    for name, read in spec.readers(c).items():
        assert callable(read), name


def test_unknown_names_are_refused():
    with pytest.raises(spec.SpecError):
        spec.find_cell(BENCH, "no-such-cell")
    with pytest.raises(spec.SpecError):
        spec.metric_reader("no.such.metric")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) <= 16
    for w in cells.values():
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")

    def reports(m, cell):
        return cell in m.get("workloads", cells)
    for cell in cells:
        others = [m for m in e2e.values()
                  if m["name"] != "setup_s" and reports(m, cell)]
        assert others, cell
        assert any(reports(m, cell) for m in BENCH["per_layer"]), cell
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    # a full check of 24 cells fits its time
    n = 24
    runs = 2 + 14 * n
    assert runs * (BENCH["run_seconds"] + 60) + n * 180 + 1200 <= 43200


COUNTED = '''
def read(rec):
    n = sum(1 for name, *_ in rec["spans"] if name == "engine.step")
    return float(n) if n else None
'''


def test_a_new_cell_mix_and_metric_run_as_new_files_only(tmp_path):
    torch.set_num_threads(1)
    root = make_root(tmp_path, metric_src=COUNTED)
    before = tree_hashes(ROOT / "portbench")
    copied = tree_hashes(root / "portbench")
    # the fixture only added files; every existing file is as it was
    assert {k: v for k, v in copied.items() if k in before} == before
    added = set(copied) - set(before)
    assert added == {"configs/tiny.json", "traffic/tiny.json",
                     f"limits/{CELL}.json", "metrics/tiny.counted.py"}
    cell = spec.find_cell(spec.load_benchmark(root), CELL, root)
    assert "tiny.counted" in {m["name"] for m in cell.per_layer}
    out = session.run_cell(cell, 5, 2.0, True, "cpu")
    assert out["metrics"]["tiny.counted"]["value"] > 0
    assert out["metrics"]["engine.fused_ms"]["value"] > 0
    assert math.isfinite(out["metrics"]["gateway.host_share"]["value"])


def test_tiny_cell_end_to_end_metrics_on_the_cpu(tmp_path):
    torch.set_num_threads(1)
    cell = tiny_cell(tmp_path)
    out = session.run_cell(cell, 2 ** 31 + 77, 2.0, False, "cpu")
    names = {m["name"] for m in cell.end_to_end}
    assert set(out["metrics"]) == names
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["correct"] and out["failed"] == 0
