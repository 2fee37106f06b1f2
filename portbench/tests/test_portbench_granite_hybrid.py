"""The granite-4.0-h family's model side (`families/granite_hybrid.py`):
it loads, its weights fit the program's layout, its reference agrees with
the repository's own copy (`tests/_granite_hybrid_ref.py`), its counts
are the hand arithmetic of the published config, its three readers give
their values on a hand-made record, and a tiny cell of the family runs
`correct` end to end on the CPU."""
import importlib.util
import json

import pytest
import torch

from _portbench_fixture import CELL, ROOT, make_root
from portbench import model, session, spec, weights

FAMILY = spec.family("granite_hybrid")
READERS = ("mamba.device_share", "mamba.state_roofline", "ssd_scan.roofline")


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def tiny_hybrid() -> dict:
    """("ssm", "attn") x 2 at d 64, 8 experts top-2 with 4 held and a
    shared expert, Granite's multipliers (an attention multiplier for
    heads of 16), f32."""
    return {"arch_id": "tiny-hybrid", "family": "hybrid", "n_layers": 4,
            "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
            "d_ff": 0, "vocab_size": 512, "block_pattern": ["ssm", "attn"],
            "moe": {"n_experts": 8, "top_k": 2, "expert_d_ff": 32,
                    "capacity_factor": 1.25, "shared_d_ff": 48,
                    "held_experts": 4},
            "ssm": {"d_state": 16, "d_conv": 4, "expand": 2, "head_dim": 16,
                    "n_groups": 1, "chunk_size": 8},
            "ssm_ffn": True, "nope": True, "embedding_multiplier": 12.0,
            "attention_multiplier": 0.5, "residual_multiplier": 0.22,
            "logits_scaling": 16.0, "tie_embeddings": True, "act": "silu",
            "rope_theta": 10000.0, "norm_eps": 1e-5, "dtype": "float32",
            "param_dtype": "float32", "attention_impl": "pallas"}


def published() -> dict:
    return json.loads((ROOT / "portbench" / "configs" /
                       "granite-4.0-h-small.json").read_text())["model"]


def test_the_family_loads_and_the_config_names_it():
    assert callable(FAMILY.state_step_bytes)
    config = json.loads((ROOT / "portbench/configs/granite-4.0-h-small.json")
                        .read_text())
    assert config["harness_family"] == "granite_hybrid"
    # the catalog's numbers at the top level, as published; the chip's
    # share of the experts in the program's `held_experts`
    assert {k: config[k] for k in config["published"]} == \
        config["published"]
    m = config["model"]
    assert (m["moe"]["n_experts"], m["moe"]["held_experts"]) == (72, 36)
    assert set(config["reduced"]) == {"held_experts"}


def test_weights_fit_the_program_layout():
    m = tiny_hybrid()
    w = weights.make(m, 2 ** 31 + 9, torch.device("cpu"), FAMILY)
    cfg = model.model_config(m)
    params = model.program_params(w, m, cfg, FAMILY)     # model._check
    mamba = params["layers"][0]["mamba"]
    assert mamba["A_log"].dtype == mamba["dt_bias"].dtype == torch.float32
    dt = torch.nn.functional.softplus(mamba["dt_bias"])
    assert 0.001 <= float(dt.min()) and float(dt.max()) <= 0.1
    assert float((-torch.exp(mamba["A_log"])).max()) < 0
    # views: the program serves the benchmark's tensors
    assert params["layers"][1]["attn"]["wq"].data_ptr() == \
        w["wq"][0].data_ptr()


def _repo_reference():
    spec_ = importlib.util.spec_from_file_location(
        "granite_hybrid_ref_tests", ROOT / "tests" / "_granite_hybrid_ref.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("quant", [None, "fp8"])
def test_the_two_reference_copies_agree(quant):
    """The benchmark's copy (stacked weights, layer by layer) and the
    repository's (the program's layout) give the same f32 logits; the
    float8 control moves them by far more."""
    m = tiny_hybrid()
    w = weights.make(m, 5, torch.device("cpu"), FAMILY)
    cfg = model.model_config(m)
    params = model.program_params(w, m, cfg, FAMILY)
    toks = [(11 * i + 5) % 509 + 2 for i in range(45)]
    P = 31
    want = _repo_reference().forward(params, cfg, toks, P)[P - 1:]
    got = FAMILY.reference_logits(w, m, {}, _Req(toks[:P], toks[P:] + [0]),
                                  quant=quant)
    if quant is None:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    else:
        assert (got - want).abs().max() > 1e-2 * want.abs().max()


class _Req:
    def __init__(self, prompt, tokens):
        self.prompt, self.tokens = prompt, tokens


def test_counts_are_the_hand_arithmetic_of_the_published_config():
    m = published()
    d, di, nh, p, n, cd = 4096, 8192, 128, 64, 128, 8448
    mamba = 2 * (d * (2 * di + 2 * n + nh) + di * d) + 2 * 4 * cd \
        + 4 * nh * p * n
    attn = 2 * (2 * d * 4096 + 2 * d * 1024)
    ffn = 2 * (d * 72 + 10 * 36 / 72 * 3 * d * 768 + 3 * d * 1536)
    per_token = 36 * mamba + 4 * attn + 40 * ffn
    assert FAMILY.token_flops(m) == per_token == 13_158_391_808
    logits = 2 * d * 100352
    attend = 4 * 4 * 32 * 128
    assert FAMILY.prefill_flops(m, 0, 1536) == \
        1536 * per_token + attend * 1536 * 1537 // 2 + logits
    assert FAMILY.decode_flops(m, [99, 2047]) == \
        2 * (per_token + logits) + attend * (100 + 2048)
    assert FAMILY.state_bytes_per_slot(m) == 36 * nh * p * n * 4 \
        == 150_994_944
    assert FAMILY.state_step_bytes(m) == 36 * (
        2 * nh * p * n * 4 + 2 * 3 * cd * 2 + (di + 2 * n + nh) * 2)
    assert FAMILY.paged_read_bytes(m, 2047, 16) == 4 * (
        2 * 2048 * 8 * 128 * 2 + 2 * 32 * 128 * 2 + 4 * 128 + 4)
    assert FAMILY.ssd_scan_flops(m, 1536) == 36 * 1536 * 4 * nh * p * n
    assert FAMILY.ssd_scan_bytes(m, 1536) == 36 * (
        1536 * (2 * di + 2 * n) * 2 + 1536 * nh * 4 + nh * 4
        + nh * p * n * 4)


def reader_record(m: dict) -> dict:
    """Two fused dispatches (3 and 1 live slots), their regions; one
    prefill before and one inside the profiled stretch (the last 2 s of
    a 10 s window), the SSD kernel's passes in the trace."""
    fused = {"step": "fused"}
    spans = [("engine.step", 7.0, 7.2, {"step": "prefill",
                                        "prompt_len": 1200, "reused": 0}),
             ("engine.step", 8.5, 8.7, {"step": "prefill",
                                        "prompt_len": 1536, "reused": 0}),
             ("engine.step", 8.8, 9.0, dict(fused, device={
                 "total_ms": 200.0, "covered_ms": 25.0, "mamba.proj": 4.0,
                 "mamba.state": 6.0, "mamba.out": 2.0, "moe.experts": 9.0})),
             ("engine.step", 9.0, 9.2, dict(fused, device={
                 "total_ms": 150.0, "covered_ms": 15.0, "mamba.proj": 3.0,
                 "mamba.state": 2.0, "mamba.out": 1.0}))]
    prof = {"window": (100.0, 102.0), "labels": [],
            "ops": [("ssd_scan_state<bf16>", 100.1, 100.2),
                    ("ssd_scan_carry", 100.15, 100.25),
                    ("ssd_scan_output<bf16>", 100.25, 100.4),
                    ("gemm", 100.5, 100.6)]}
    return {"model": m, "family": FAMILY, "mix": {"block_size": 16},
            "t0": 0.0, "t1": 10.0, "window_s": 10.0, "spans": spans,
            "gateway_steps": [(7.9, 8.1), (8.2, 8.4), (8.4, 8.75)],
            "fused": [{"profiled": True,
                       "slots": [(1300, 8), (1500, 8), (2000, 3)]},
                      {"profiled": True, "slots": [(1400, 8)]}],
            "single": [], "profile": prof,
            "cache": {"start": {}, "end": {}}}


def test_readers_give_their_values_on_a_hand_made_record():
    m = published()
    rec = reader_record(m)
    got = {r: spec.metric_reader(r)(rec) for r in READERS}
    assert got["mamba.device_share"] == pytest.approx(
        100 * (4 + 6 + 2 + 3 + 2 + 1) / (25 + 15))
    need = 4 * FAMILY.state_step_bytes(m)
    assert got["mamba.state_roofline"] == pytest.approx(
        100 * need / 3.35e12 / 8e-3)
    bound = max(FAMILY.ssd_scan_flops(m, 1536) / 989e12,
                FAMILY.ssd_scan_bytes(m, 1536) / 3.35e12)
    assert got["ssd_scan.roofline"] == pytest.approx(100 * bound / 0.3)
    # absent inputs read nothing
    bare = dict(rec, spans=[], fused=[], profile=None)
    assert all(spec.metric_reader(r)(bare) is None for r in READERS)


def test_a_tiny_cell_runs_correct_on_the_cpu(tmp_path):
    """The family's tiny model through `session.run_cell`: one gateway
    over the paged, fused engine with each slot's Mamba2 state, checked
    against the benchmark's reference; the traced run's readers read the
    regions (no CUDA kernel runs on the CPU, so the SSD roofline reads
    nothing)."""
    root = make_root(tmp_path, family="granite_hybrid")
    cfg_file = root / "portbench" / "configs" / "tiny.json"
    config = json.loads(cfg_file.read_text())
    config["model"] = tiny_hybrid()
    cfg_file.write_text(json.dumps(config))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert all(CELL in mt["workloads"] for mt in bench["per_layer"]
               if mt["name"] in READERS)
    cell = spec.find_cell(bench, CELL, root)
    assert cell.family.__name__.endswith("granite_hybrid")
    quiet = session.run_cell(cell, 2 ** 31 + 11, 2.0, False, "cpu")
    assert quiet["correct"], quiet["checks"]
    assert quiet["readings"]["max_logit_gap"] <= 1e-5
    traced = session.run_cell(cell, 2 ** 31 + 11, 2.0, True, "cpu")
    assert traced["correct"], traced["checks"]
    for name in ("mamba.device_share", "mamba.state_roofline"):
        assert 0 < traced["metrics"][name]["value"]
    assert traced["metrics"]["mamba.device_share"]["value"] < 100
    assert "ssd_scan.roofline" not in traced["metrics"]
