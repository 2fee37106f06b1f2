"""The readers of the program's device regions and host spans, worked by
hand over synthetic records: `moe.device_share`, `moe.movement_share`,
`prefill.attn_share`, `engine.fused_device_ms`, `engine.reconcile_ms`,
`gateway.self_share`. Each reads nothing, and returns None, from a
record of a program without those spans or readings."""
import pytest

from _portbench_fixture import ROOT
from portbench import spec

NEW = ("moe.device_share", "moe.movement_share", "prefill.attn_share",
       "engine.fused_device_ms", "engine.reconcile_ms",
       "gateway.self_share")


def _read(name, spans, window_s=10.0):
    return spec.metric_reader(name, ROOT)({"spans": spans,
                                           "window_s": window_s})


def _fused(t0, device):
    return ("engine.step", t0, t0 + 0.1,
            {"step": "fused", "live": 4, "device": device})


FUSED = [
    _fused(1.0, {"total_ms": 80.0, "covered_ms": 10.0, "attn.proj": 1.0,
                 "attn.core": 2.0, "moe.route": 1.0, "moe.dispatch": 2.0,
                 "moe.experts": 3.0, "moe.combine": 0.5, "logits": 0.25}),
    _fused(2.0, {"total_ms": 60.0, "covered_ms": 6.0, "moe.route": 0.5,
                 "moe.dispatch": 1.0, "moe.experts": 1.5,
                 "moe.combine": 0.5}),
]
PREFILL = [
    ("engine.step", 0.5, 0.6, {"step": "prefill", "prompt_len": 9,
                               "reused": 0,
                               "device": {"total_ms": 40.0,
                                          "attn.core": 10.0,
                                          "attn.proj": 5.0}}),
    ("engine.step", 3.0, 3.1, {"step": "prefill", "prompt_len": 9,
                               "reused": 0,
                               "device": {"total_ms": 60.0,
                                          "attn.core": 20.0}}),
]
# a program without device readings: the same spans, bare
BARE = [(n, a, b, {k: v for k, v in args.items() if k != "device"})
        for n, a, b, args in FUSED + PREFILL]


def test_moe_device_share():
    # (1 + 2 + 3 + 0.5) + (0.5 + 1 + 1.5 + 0.5) over 10 + 6 covered ms
    assert _read("moe.device_share", FUSED + PREFILL) == \
        pytest.approx(100.0 * 10.0 / 16.0)


def test_moe_device_share_needs_moe_regions():
    dense = [_fused(1.0, {"total_ms": 50.0, "covered_ms": 7.0,
                          "ffn": 3.0})]
    assert _read("moe.device_share", dense) is None


def test_moe_movement_share():
    # route + dispatch + combine: 3.5 + 2.0 of 10.0 moe ms
    assert _read("moe.movement_share", FUSED) == \
        pytest.approx(100.0 * 5.5 / 10.0)


def test_prefill_attn_share_reads_prefills_only():
    assert _read("prefill.attn_share", FUSED + PREFILL) == \
        pytest.approx(100.0 * 30.0 / 100.0)


def test_fused_device_ms_is_the_mean_replay():
    assert _read("engine.fused_device_ms", FUSED + PREFILL) == \
        pytest.approx(70.0)


def test_reconcile_ms_reads_fused_reconciles_only():
    spans = [("engine.reconcile", 1.0, 1.004, {"step": "fused", "live": 4}),
             ("engine.reconcile", 2.0, 2.002, {"step": "fused", "live": 4}),
             ("engine.reconcile", 3.0, 3.5, {"step": "decode", "live": 4})]
    assert _read("engine.reconcile_ms", spans) == pytest.approx(3.0)


def test_gateway_self_share_less_the_engine_steps_inside():
    spans = [("gateway.step", 1.0, 1.5, {}),
             ("engine.step", 1.1, 1.3, {"step": "fused"}),
             ("engine.step", 1.3, 1.4, {"step": "prefill"}),
             ("gateway.step", 2.0, 2.25, {}),
             ("engine.step", 2.05, 2.2, {"step": "fused"}),
             ("gateway.dispatch", 2.0, 2.01, {}),
             # outside every gateway step: not subtracted
             ("engine.step", 3.0, 3.9, {"step": "fused"})]
    # (0.5 - 0.3) + (0.25 - 0.15) = 0.3 s of a 10 s window
    assert _read("gateway.self_share", spans) == pytest.approx(3.0)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_reads_none(name):
    assert _read(name, BARE) is None
    assert _read(name, []) is None


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_is_in_the_benchmark(name):
    bench = spec.load_benchmark(ROOT)
    m = {x["name"]: x for x in bench["per_layer"]}[name]
    assert m["source"] == "program_span" and m["workloads"]
    assert (ROOT / "portbench" / "metrics" / f"{name}.py").is_file()
