"""granite-4.0-h in the port (Mamba2 layers with an MoE FFN, a shared
expert, NoPE attention, Granite's multipliers, a layer holding a share of
the experts) against the plain f32 reference `_granite_hybrid_ref.py`, on
the CPU: the full-sequence forward, the paged layout's bulk prefill and
decode steps (each slot's Mamba2 state beside the KV pages), the engine's
single and fused decode, the expert shares, the slot state on admission,
and what the paged engine refuses or skips for a recurrent model.

Tiny config: ("ssm", "attn") x 2, d 64, 4/2 heads of 16 (attention
multiplier 0.5: the published 1/128 is for heads of 128, and would leave
these heads' attention nearly uniform), Mamba2 8 heads of 16 with d_state
16 (chunk 8), 8 experts top-2 of width 32 with 4 held and a shared expert
of 48, vocab 512, f32, seeded weights with every norm scale and the conv
bias drawn away from the port's zero init. Imports no JAX.

Tolerance `TOL` 2e-6 on logits of up to about 0.08 (the logits are divided
by 16): the port and the reference compute the same f32 sums in other
orders (the SSD chunked or sequential against the dual form, attention by
blocks or pages), a few f32 roundings apart; every option checked here
moves the logits by over 100 times that.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import reporting
from repro_torch.gateway.gateway import Gateway
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine
from _granite_hybrid_ref import forward as ref_forward
from _granite_hybrid_ref import moe as ref_moe
from _torch_host import one_torch_thread  # noqa: F401
from _torch_host import shut_down_gateways  # noqa: F401

TOL = 2e-6
BS = 8


def tiny(**kw):
    base = registry.get("granite-4.0-h-small", reduced=True)
    cfg = base.replace(
        d_model=64, n_layers=4, block_pattern=("ssm", "attn"), n_heads=4,
        n_kv_heads=2, head_dim=16, vocab_size=512,
        ssm=dataclasses.replace(base.ssm, d_state=16, head_dim=16,
                                chunk_size=8),
        moe=dataclasses.replace(base.moe, n_experts=8, top_k=2,
                                expert_d_ff=32, shared_d_ff=48,
                                held_experts=4),
        attention_multiplier=0.5)
    return cfg.replace(**kw)


def _drawn(cfg, seed=0):
    """init_lm's weights, with the leaves it zeroes (norm scales, the conv
    bias) drawn in +-0.2 so that the comparison covers them."""
    params = T.init_lm(torch.Generator().manual_seed(seed), cfg)
    g = torch.Generator().manual_seed(seed + 1)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k in ("scale", "norm_scale", "conv_b"):
                tree[k] = (torch.rand(v.shape, generator=g) - 0.5) * 0.4
    for lp in params["layers"]:
        fill(lp)
    fill(params["final_norm"])
    return params


@pytest.fixture(scope="module")
def model():
    cfg = tiny()
    return cfg, _drawn(cfg)


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(1, 512, n).tolist()


def _variant(cfg, params, name):
    """(cfg, params) with one of Granite's settings off (or RoPE on, or all
    the experts held), over the same weights where the layout allows."""
    if name == "granite":
        return cfg, params
    if name == "rope":
        return cfg.replace(nope=False), params
    if name in ("embedding_multiplier", "residual_multiplier",
                "logits_scaling"):
        return cfg.replace(**{name: 1.0}), params
    if name == "attention_multiplier":
        return cfg.replace(attention_multiplier=0.0), params
    out = {**params, "layers": [dict(lp) for lp in params["layers"]]}
    if name == "no_shared":
        for lp in out["layers"]:
            lp["ffn"] = {k: v for k, v in lp["ffn"].items() if k != "shared"}
        return cfg.replace(moe=dataclasses.replace(cfg.moe, shared_d_ff=0)), \
            out
    assert name == "all_experts"
    g = torch.Generator().manual_seed(7)
    for lp in out["layers"]:
        f = lp["ffn"] = dict(lp["ffn"])
        for k in ("w_gate", "w_up", "w_down"):
            f[k] = torch.cat([f[k], torch.rand(f[k].shape, generator=g)
                              * 2 * f[k].abs().max() - f[k].abs().max()])
    return cfg.replace(moe=dataclasses.replace(cfg.moe, held_experts=0)), out


VARIANTS = ["granite", "embedding_multiplier", "attention_multiplier",
            "residual_multiplier", "logits_scaling", "rope", "no_shared",
            "all_experts"]


# ------------------------------------------------------------------ config

def test_registered_for_the_port_only():
    cfg = registry.get("granite-4.0-h-small")
    assert "granite-4.0-h-small" in registry.SERVE_ARCH_IDS
    assert "granite-4.0-h-small" not in registry.ARCH_IDS
    types = cfg.layer_types()
    assert [i for i, t in enumerate(types) if t == "attn"] == [5, 15, 25, 35]
    assert types.count("ssm") == 36
    assert round(cfg.param_count() / 1e9, 1) == 32.2
    assert T.paged_supported(cfg) and T.recurrent(cfg)
    # a stack with no attention layer, or with RG-LRU layers, stays dense
    assert not T.paged_supported(registry.get("mamba2-130m"))
    assert not T.paged_supported(registry.get("recurrentgemma-9b"))


def test_port_only_defaults_leave_a_model_as_it_was():
    """Every port-only field at its default: a registered model's layer
    shapes and init draws are what they were (no norm2/ffn on Mamba2
    layers, no shared expert, every expert held)."""
    cfg = registry.get("mamba2-130m", reduced=True)
    assert set(T.param_shapes(cfg)["layers"][0]) == {"norm1", "mamba"}
    cfg = registry.get("granite-moe-1b-a400m", reduced=True)
    ffn = T.param_shapes(cfg)["layers"][0]["ffn"]
    assert set(ffn) == {"router", "w_gate", "w_up", "w_down"}
    assert ffn["w_gate"][0] == cfg.moe.padded_n_experts
    assert cfg.attention_scale == 1.0 / np.sqrt(cfg.resolved_head_dim)


# ---------------------------------------------------------- full sequence

@pytest.mark.parametrize("name", VARIANTS)
def test_forward_prefill_matches_reference(model, name):
    """forward_prefill's logits against the reference, with each of
    Granite's settings on and off; each setting moves the logits."""
    cfg, params = _variant(*model, name)
    toks = _tokens(37)
    got = T.forward_prefill(params, cfg, {"tokens": torch.tensor([toks])})[0]
    want = ref_forward(params, cfg, toks, len(toks))
    torch.testing.assert_close(got[0], want, rtol=0, atol=TOL)
    if name != "granite":
        base = ref_forward(model[1], model[0], toks, len(toks))
        assert (want - base).abs().max() > 100 * TOL


def test_expert_shares_add_up_to_the_uncut_layer(model):
    """Two devices' halves of an expert layer (experts 0-3 and 4-7 of 8,
    the router whole on both), the shared expert counted once, add up to
    the layer that holds all eight; the uncut reference agrees."""
    cfg, params = _variant(*model, "all_experts")
    full = params["layers"][0]["ffn"]
    x = torch.randn((1, 29, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    whole, _ = MOE.moe_ffn(full, cfg, x)
    parts = []
    for first, shared in ((0, True), (4, False)):
        c = cfg.replace(moe=dataclasses.replace(
            cfg.moe, held_experts=4, first_held=first,
            shared_d_ff=cfg.moe.shared_d_ff if shared else 0))
        p = {k: full[k][first:first + 4] for k in ("w_gate", "w_up",
                                                   "w_down")}
        p["router"] = full["router"]
        if shared:
            p["shared"] = full["shared"]
        parts.append(MOE.moe_ffn(p, c, x)[0])
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=0, atol=1e-6)
    torch.testing.assert_close(whole[0], ref_moe(x[0], full, cfg, 29),
                               rtol=0, atol=1e-6)
    assert parts[1].abs().max() > 1e-3          # the second half adds


# ---------------------------------------------------------- paged layout

def test_paged_prefill_and_decode_match_reference(model):
    """A bulk prefill into slot 1 of 3 (exact length, its Mamba2 state
    written into row 1), then six decode steps: every step's logits
    against the reference's full forward over the prompt and the tokens
    served; the empty slots' state rows stay zero."""
    cfg, params = model
    nb = 8
    cache = T.init_paged_cache(cfg, 3 * nb + 1, BS, "cpu", slots=3)
    table = np.zeros((3, nb), np.int32)
    table[1] = np.arange(1, nb + 1)
    prompt = _tokens(21, 1)
    logits, _ = T.forward_prefill_paged(
        params, cfg, torch.tensor([prompt]), 0, len(prompt), cache,
        torch.tensor(table[1]), slot=1)
    seq = list(prompt)
    rows = [logits[0, -1]]
    for _ in range(6):
        seq.append(int(rows[-1].argmax()))
        toks = torch.zeros((3, 1), dtype=torch.int32)
        toks[1, 0] = seq[-1]
        pos = torch.tensor([0, len(seq) - 1, 0], dtype=torch.int32)
        out, _ = T.decode_step_paged(params, cfg, toks, pos, cache,
                                     torch.tensor(table))
        rows.append(out[1, 0])
    want = ref_forward(params, cfg, seq, len(prompt))[len(prompt) - 1:]
    torch.testing.assert_close(torch.stack(rows), want, rtol=0, atol=TOL)
    for c in cache:
        if "ssm" in c:
            for t in c.values():
                assert t[1].abs().max() > 0
                assert not t[0].any() and not t[2].any()


def _gaps(params, cfg, reqs):
    """Per request: the widest gap by which a served token's reference
    logit lies below the reference's best (0 where greedy serving and the
    reference agree)."""
    out = []
    for r in reqs:
        want = ref_forward(params, cfg, r.prompt + r.output[:-1],
                           len(r.prompt))[len(r.prompt) - 1:]
        got = want.gather(1, torch.tensor(r.output)[:, None])[:, 0]
        out.append(float((want.max(-1).values - got).max()))
    return out


@pytest.mark.parametrize("prefill_mode", ["bulk", "decode"])
@pytest.mark.parametrize("fused", [1, 4])
def test_engine_serves_the_reference_tokens(model, fused, prefill_mode):
    """The paged engine (bulk or decode-mode prefill, single or fused
    decode steps, slots reused as requests retire) serves the tokens the
    reference ranks first."""
    cfg, params = model
    eng = ServeEngine(params, cfg, batch_slots=3, cache_len=64,
                      prefill_mode=prefill_mode, kv_layout="paged",
                      block_size=BS, fused_tokens=fused, device="cpu")
    reqs = [eng.submit(_tokens(n, 10 + n), max_new_tokens=m)
            for n, m in ((20, 12), (33, 5), (6, 14), (27, 9))]
    eng.run()
    assert all(len(r.output) == r.max_new_tokens for r in reqs)
    assert max(_gaps(params, cfg, reqs)) <= TOL
    assert eng.state_summary()["slots_cleared"] == 4


def test_slot_state_does_not_depend_on_what_it_served(model):
    """A request served in a slot that served another one first gets the
    same tokens, and leaves the same state, as in a fresh engine: its
    admission overwrote (bulk) or cleared (decode-mode prefill) the
    slot's state."""
    cfg, params = model
    for mode in ("bulk", "decode"):
        runs = []
        for before in ([], [_tokens(30, 5)]):
            eng = ServeEngine(params, cfg, batch_slots=1, cache_len=64,
                              prefill_mode=mode, kv_layout="paged",
                              block_size=BS, fused_tokens=4, device="cpu")
            for p in before:
                eng.submit(p, max_new_tokens=7)
            req = eng.submit(_tokens(18, 6), max_new_tokens=9)
            eng.run()
            runs.append((req.output, [t.clone() for c in eng.cache
                                      if "ssm" in c for t in c.values()]))
            assert eng.state_summary()["slots_cleared"] == 1 + len(before)
        assert runs[0][0] == runs[1][0]
        for a, b in zip(runs[0][1], runs[1][1]):
            assert torch.equal(a, b)


def test_recurrent_engine_refuses_chunked_and_speculative(model):
    cfg, params = model
    kw = dict(batch_slots=2, cache_len=64, kv_layout="paged",
              block_size=BS, device="cpu")
    with pytest.raises(ValueError, match="chunked scheduler"):
        ServeEngine(params, cfg, scheduler="chunked", **kw)
    with pytest.raises(ValueError, match="speculative decoding"):
        ServeEngine(params, cfg, spec_tokens=2, **kw)
    cache = T.init_paged_cache(cfg, 9, BS, "cpu", slots=2)
    with pytest.raises(ValueError, match="attention stacks only"):
        T.verify_step_paged(params, cfg, torch.zeros((2, 3), dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32), cache,
                            torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="whole prompt, unpadded"):
        T.forward_prefill_paged(params, cfg, torch.ones((1, 8), dtype=torch.int32),
                                0, 5, cache, torch.arange(1, 9), slot=0)


def test_no_prefix_reuse_for_a_recurrent_model(model):
    """Prompts sharing a 40-token prefix: no radix lookup, no hit, no
    copy-on-write, nothing indexed; the pool holds one slots' worth of
    pages and the null page."""
    cfg, params = model
    eng = ServeEngine(params, cfg, batch_slots=2, cache_len=64,
                      prefill_mode="bulk", kv_layout="paged", block_size=BS,
                      fused_tokens=4, device="cpu")
    shared = _tokens(40, 9)
    reqs = [eng.submit(shared + _tokens(5, s), max_new_tokens=6)
            for s in (1, 2, 3)]
    eng.run()
    m = eng.cache_metrics
    assert (m.hits, m.tokens_reused, m.cow_copies, m.inserts) == (0, 0, 0, 0)
    assert m.misses == 3 and eng.manager.radix.all_blocks() == []
    assert eng.manager.pool.n_blocks == 2 * (64 // BS) + 1
    assert eng.cached_prefix_tokens(reqs[0].prompt) == 0
    assert max(_gaps(params, cfg, reqs)) <= TOL


def test_gateway_reports_the_state_counters(model):
    cfg, params = model
    gw = Gateway.build(params, cfg, replicas=1, batch_slots=2, cache_len=64,
                       prefill_mode="bulk", kv_layout="paged", block_size=BS,
                       fused_tokens=4, device="cpu")
    handles = [gw.submit(_tokens(12, s), max_new_tokens=5) for s in (1, 2)]
    gw.run()
    assert [h.status for h in handles] == ["done", "done"]
    steps = gw.engine_step_summary()
    assert steps["state_slots_cleared"] == 2
    # two Mamba2 layers, 2 slots: ssm (8 x 16 x 16) f32, conv (3 x 160) f32
    assert steps["state_bytes_held"] == 2 * 2 * (8 * 16 * 16 + 3 * 160) * 4
    table = reporting.engine_steps_table(steps)
    assert "state_slots_cleared" in table and "state_*: count, bytes" in table
