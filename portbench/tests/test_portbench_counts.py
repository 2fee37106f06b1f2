"""Operation and byte counts against hand-worked small shapes, and the
per-layer readers on hand-made records."""
import pytest

from portbench import spec

D = spec.family("decoder")

DENSE = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "vocab_size": 10, "dtype": "bfloat16"}
MOE = dict(DENSE, d_ff=0, moe={"n_experts": 4, "top_k": 2,
                               "expert_d_ff": 3, "capacity_factor": 1.25})


def test_layer_params_by_hand():
    # attention: 8*8 + 2*8*4 + 8*8 = 192; FFN 3*8*16 = 384
    assert D.layer_matmul_params(DENSE) == 192 + 384
    # MoE: router 8*4 = 32, top-2 experts 2 * 3*8*3 = 144
    assert D.layer_matmul_params(MOE) == 192 + 32 + 144


def test_token_and_step_flops_by_hand():
    # one token at context 3: 2 layers * (2 * 576 + 4*2*4*3) = 2496
    assert D.token_flops(DENSE, 3) == 2 * (2 * 576 + 96)
    assert D.logits_flops(DENSE) == 160
    assert D.decode_flops(DENSE, [2]) == 2496 + 160
    # prefill of positions 2..4 after a reused prefix of 2: contexts 3,4,5
    want = (3 * 2 * 2 * 576 + 2 * 4 * 2 * 4 * (3 + 4 + 5) + 160)
    assert D.prefill_flops(DENSE, 2, 3) == want
    assert D.prefill_flops(DENSE, 0, 3) == sum(
        D.token_flops(DENSE, c) for c in (1, 2, 3)) + 160


def test_paged_read_bytes_by_hand():
    # position 17, pages of 16: K and V of 18 positions, 1 kv head of 4,
    # bf16: 2*18*4*2 = 288; q and out 2*2*4*2 = 32; 2 block ids and the
    # position: 12; in each of the 2 layers
    assert D.layer_read_bytes(DENSE, 17, 16) == 288 + 32 + 12
    assert D.paged_read_bytes(DENSE, 17, 16) == 2 * (288 + 32 + 12)


def _rec(spans, **kw):
    rec = {"model": DENSE, "family": D, "mix": {"block_size": 16},
           "window_s": 2.0, "spans": spans, "gateway_steps": [(0.0, 1.5)], "fused": [],
           "single": [], "profile": None,
           "cache": {"start": {"tokens_reused": 0, "tokens_computed": 0},
                     "end": {"tokens_reused": 0, "tokens_computed": 0}}}
    rec.update(kw)
    return rec


def read(name, rec):
    return spec.metric_reader(name)(rec)


def test_span_readers_by_hand():
    spans = [("engine.step", 0.0, 0.1, {"step": "prefill", "prompt_len": 3,
                                        "reused": 0}),
             ("engine.step", 0.2, 0.5, {"step": "fused"}),
             ("engine.step", 0.6, 0.8, {"step": "fused"}),
             ("gateway.dispatch", 0.1, 0.15, {})]
    rec = _rec(spans, fused=[{"profiled": False, "slots": [(4, 2)]}])
    assert read("engine.fused_ms", rec) == pytest.approx(250.0)
    assert read("engine.prefill_ms", rec) == pytest.approx(100.0)
    # 1.5 s inside Gateway.step, 0.6 s of it engine steps, over 2 s
    assert read("gateway.host_share", rec) == pytest.approx(45.0)
    want = D.decode_flops(DENSE, [4, 5]) / (0.5 * 989e12) * 100
    assert read("mfu.decode", rec) == pytest.approx(want)
    want = D.prefill_flops(DENSE, 0, 3) / (0.1 * 989e12) * 100
    assert read("mfu.prefill", rec) == pytest.approx(want)
    assert read("engine.fused_ms", _rec([])) is None


def test_counter_and_trace_readers_by_hand():
    rec = _rec([], cache={"start": {"tokens_reused": 10,
                                    "tokens_computed": 5},
                          "end": {"tokens_reused": 40,
                                  "tokens_computed": 15}})
    assert read("kv.reuse_share", rec) == pytest.approx(75.0)
    assert read("kv.reuse_share", _rec([])) is None
    prof = {"window": (0.0, 1.0), "labels": [],
            "ops": [("paged_attention_split<bf16>", 0.1, 0.3),
                    ("paged_attention_combine<bf16>", 0.25, 0.35),
                    ("gemm", 0.5, 0.6)]}
    rec = _rec([], profile=prof, fused=[
        {"profiled": True, "slots": [(15, 2)]},
        {"profiled": False, "slots": [(99, 8)]}])
    assert read("device.idle_share", rec) == pytest.approx(65.0)
    need = (D.paged_read_bytes(DENSE, 15, 16)
            + D.paged_read_bytes(DENSE, 16, 16))
    want = 100 * need / 3.35e12 / 0.25
    assert read("paged_attn.roofline", rec) == pytest.approx(want)
    assert read("paged_attn.roofline", _rec([])) is None
