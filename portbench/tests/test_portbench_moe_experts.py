"""The `moe_experts.roofline` reader on hand-made records: the held
experts' weight bytes once per MoE layer per profiled decode step (all
`fused_tokens` steps of a fused replay, one a single step) over 3.35 TB/s,
against the union of the grouped kernel's gate/up and down intervals; and
nothing from a program without the kernel or a model without experts."""
import json

import pytest

from _portbench_fixture import ROOT
from portbench import spec

READER = "moe_experts.roofline"
MOE = {"n_layers": 3, "d_model": 128, "n_heads": 2, "n_kv_heads": 1,
       "head_dim": 64, "d_ff": 0, "vocab_size": 10, "dtype": "bfloat16",
       "moe": {"n_experts": 8, "top_k": 2, "expert_d_ff": 64,
               "capacity_factor": 1.25}}
PROF = {"window": (0.0, 1.0), "labels": [],
        "ops": [("moe_experts_gate_up", 0.1, 0.3),
                ("moe_experts_down", 0.25, 0.35),
                ("moe_dispatch_sort", 0.05, 0.1),
                ("gemm", 0.5, 0.6)]}


def _rec(m, profile=PROF):
    return {"model": m, "mix": {"fused_tokens": 8, "block_size": 16},
            "profile": profile,
            "fused": [{"profiled": True, "slots": [(4, 8), (9, 2)]},
                      {"profiled": False, "slots": [(99, 8)]}],
            "single": [{"profiled": True, "slots": [(12, 1)]}]}


def _read(rec):
    return spec.metric_reader(READER, ROOT)(rec)


def test_the_roofline_by_hand():
    # 9 steps (8 fused, 1 single) x 3 layers x 3 x 8 x 128 x 64 x 2 bytes
    # over 3.35 TB/s against 0.25 s of the kernel (0.1-0.35)
    need = 9 * 3 * 3 * 8 * 128 * 64 * 2
    assert _read(_rec(MOE)) == pytest.approx(100 * need / 3.35e12 / 0.25)
    held = dict(MOE, moe=dict(MOE["moe"], held_experts=4))
    assert _read(_rec(held)) == pytest.approx(_read(_rec(MOE)) / 2)
    hybrid = dict(held, n_layers=4, block_pattern=["ssm", "attn"])
    assert _read(_rec(hybrid)) == pytest.approx(_read(_rec(held)) * 2 / 3)
    assert _read(_rec(dict(hybrid, ssm_ffn=True))) == pytest.approx(
        _read(_rec(held)) * 4 / 3)


def test_nothing_to_read():
    bare = dict(PROF, ops=[op for op in PROF["ops"]
                           if not op[0].startswith("moe_experts")])
    assert _read(_rec(MOE, bare)) is None
    assert _read(_rec(MOE, None)) is None
    dense = {k: v for k, v in MOE.items() if k != "moe"}
    assert _read(_rec(dense)) is None


def test_its_entry_names_the_moe_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry, = [m for m in bench["per_layer"] if m["name"] == READER]
    assert entry["moves"] == "tpot_p90_ms" and entry["layer"] == "kernels"
    cells = {c["name"]: c["config"] for c in bench["workloads"]}
    for cell in entry["workloads"]:
        config = json.loads((ROOT / "portbench" / "configs" /
                             f"{cells[cell]}.json").read_text())
        assert config["model"].get("moe"), cell
