"""granite-4.0-h on the card, at its published widths and one period of
its depth (10 layers: 9 Mamba2 and the attention layer at 5), bf16, 36 of
the 72 experts held: the paged bulk prefill (the SSD kernel, the paged
flash kernel) and the fused decode graph (each slot's state stepped in
place, the paged decode kernel) against the plain f32 reference
`_granite_hybrid_ref.py`; the SSD kernel's route at 128 heads of 64 and
d_state 128; the in-place state step inside a captured graph against the
eager step.

Marked `gpu`: skips where torch sees no CUDA device. Imports no JAX. Run
on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_granite_hybrid_cuda.py``.

Tolerance `REL` 0.05 of the reference's largest logit: bf16 weights and
activations through 10 layers (logits divided by 16) read a few percent
of it; a decode that lost the prompt's state (zeroed after the prefill)
reads more, and fails it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as T
from repro_torch.serve.graph import FusedDecodeGraph
from repro_torch.serve.step import build_decode_fused
from _granite_hybrid_ref import forward as ref_forward

pytestmark = pytest.mark.gpu

REL = 0.05
SLOTS, BS, NB, N = 8, 16, 64, 8


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SSD, flash and paged kernels "
                    "and the graph have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(device):
    full = registry.get("granite-4.0-h-small")
    cfg = full.replace(n_layers=10, dtype="bfloat16", param_dtype="bfloat16",
                       attention_impl="pallas",
                       moe=dataclasses.replace(full.moe, held_experts=36))
    params = T.init_lm(torch.Generator(device=device).manual_seed(0), cfg)
    g = torch.Generator(device=device).manual_seed(1)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k in ("scale", "norm_scale", "conv_b"):
                tree[k] = ((torch.rand(v.shape, generator=g, device=device)
                            - 0.5) * 0.2).to(v.dtype)
    for lp in params["layers"]:
        fill(lp)
    return cfg, params


def _rel(got, want):
    return float((got.float() - want).abs().max() / want.abs().max())


def test_prefill_and_fused_decode_match_reference(model, device):
    """A 700-token prompt prefilled into slot 3 of 8, then one fused
    dispatch of 8 tokens (a CUDA graph) beside an empty and a finished
    slot: the prefill's and every decode step's logits against the
    reference over the prompt and the tokens served. The prefill launches
    the SSD kernel once per Mamba2 layer on its tensor-core route, the
    graph the paged decode kernel once per step."""
    cfg, params = model
    cache = T.init_paged_cache(cfg, SLOTS * NB + 1, BS, device, SLOTS)
    table = np.zeros((SLOTS, NB), np.int32)
    table[3] = np.arange(1, NB + 1)
    prompt = np.random.default_rng(0).integers(2, cfg.vocab_size,
                                               700).tolist()
    mma0 = ssd_ops.ssd_scan.route_launches["mma"]
    logits, _ = T.forward_prefill_paged(
        params, cfg, torch.tensor([prompt], device=device), 0, len(prompt),
        cache, torch.tensor(table[3], device=device), slot=3)
    assert ssd_ops.ssd_scan.route_launches["mma"] - mma0 == 9
    first = int(logits[0, -1].argmax())
    fused = FusedDecodeGraph(build_decode_fused(cfg, N))
    ints = {"tokens": np.zeros((SLOTS, 1)), "pos": np.zeros(SLOTS),
            "eos": np.full(SLOTS, -1), "steps": np.zeros(SLOTS)}
    ints["tokens"][3, 0], ints["pos"][3], ints["steps"][3] = \
        first, len(prompt), N
    live = torch.zeros(SLOTS, dtype=torch.bool, device=device)
    live[3] = True
    args = {k: torch.as_tensor(v.astype(np.int32), device=device)
            for k, v in ints.items()}
    launches0 = pa_ops.paged_attention.launches
    emitted, _, _, _ = fused(params, args["tokens"], args["pos"], cache,
                             torch.tensor(table, device=device), args["eos"],
                             live, args["steps"])
    assert fused.replays == 1 and fused.captures == 1
    # one attention layer: a launch per step of the replay and of each
    # eager warm-up run before the capture
    assert pa_ops.paged_attention.launches - launches0 == \
        N * (fused.replays + fused.warmup_runs)
    served = [first] + emitted[:, 3].tolist()
    assert min(served) >= 0
    want = ref_forward(params, cfg, prompt + served[:-1], len(prompt))[
        len(prompt) - 1:]
    assert _rel(logits[0, -1], want[0]) <= REL
    # each decode step's logits: the served token's reference logit lies
    # within REL of the reference's best
    gap = want.max(-1).values - want.gather(
        1, torch.tensor(served, device=device)[:, None])[:, 0]
    assert float(gap.max() / want.abs().max()) <= REL
    # the bound sees a lost state: the first decode step from zero state
    for c in cache:
        if "ssm" in c:
            for t in c.values():
                t[3].zero_()
    toks = torch.zeros((SLOTS, 1), dtype=torch.int32, device=device)
    toks[3, 0] = first
    pos = torch.zeros(SLOTS, dtype=torch.int32, device=device)
    pos[3] = len(prompt)
    lost, _ = T.decode_step_paged(params, cfg, toks, pos, cache,
                                  torch.tensor(table, device=device))
    assert _rel(lost[3, 0], want[1]) > REL


def test_ssd_kernel_route_at_full_width(model, device):
    """A Mamba2 layer's prefill at 128 heads of 64 and d_state 128 runs
    the SSD kernel's tensor-core route (its x, B and C read in place from
    the conv output), within REL of the plain chunked route in f32."""
    cfg, params = model
    lp = params["layers"][0]["mamba"]
    u = torch.randn((1, 333, cfg.d_model), generator=torch.Generator(
        device=device).manual_seed(2), device=device).to(torch.bfloat16)
    before = dict(ssd_ops.ssd_scan.route_launches)
    out, state = M2.mamba2_forward(lp, cfg, u)
    assert ssd_ops.ssd_scan.route_launches["mma"] == before["mma"] + 1
    assert ssd_ops.ssd_scan.route_launches["simt"] == before["simt"]
    f32 = cfg.replace(dtype="float32", attention_impl="xla")
    p32 = {k: v.float() for k, v in lp.items()}
    ref, ref_state = M2.mamba2_forward(p32, f32, u.float())
    assert _rel(out, ref) <= REL
    assert _rel(state["ssm"], ref_state["ssm"]) <= REL


def test_state_step_in_a_captured_graph_matches_eager(model, device):
    """`mamba2_decode_paged` captured in a CUDA graph and replayed steps
    the state rows of the live slots in place exactly as the eager step
    does, and leaves the dead slots' rows as they were."""
    cfg, params = model
    lp = params["layers"][0]["mamba"]
    g = torch.Generator(device=device).manual_seed(4)
    state = T.init_paged_cache(cfg, 2, BS, device, SLOTS)[0]
    for t in state.values():
        t.copy_(torch.randn(t.shape, generator=g, device=device) * 0.1)
    u = (torch.randn((SLOTS, 1, cfg.d_model), generator=g, device=device)
         ).to(torch.bfloat16)
    live = torch.tensor([True, False, True, True, False, True, True, True],
                        device=device)
    eager = {k: v.clone() for k, v in state.items()}
    want = M2.mamba2_decode_paged(lp, cfg, u, eager, live)
    graphed = {k: v.clone() for k, v in state.items()}
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    warm = {k: v.clone() for k, v in state.items()}
    with torch.cuda.stream(side):
        M2.mamba2_decode_paged(lp, cfg, u, warm, live)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = M2.mamba2_decode_paged(lp, cfg, u, graphed, live)
    for k in state:                 # the capture ran nothing
        assert torch.equal(graphed[k], state[k])
    graph.replay()
    torch.cuda.synchronize(device)
    assert torch.equal(got, want)
    for k in state:
        assert torch.equal(graphed[k], eager[k])
        assert torch.equal(graphed[k][~live], state[k][~live])
        assert not torch.equal(graphed[k][live], state[k][live])


def test_slot_state_does_not_depend_on_what_it_served(model, device):
    """The paged, fused engine on the card: a request admitted into the
    slot that served another one first gets the tokens it gets in a fresh
    engine, and leaves the same state in its slot (its bulk prefill
    overwrote the slot's state)."""
    from repro_torch.serve.engine import ServeEngine
    cfg, params = model
    rng = np.random.default_rng(5)
    first = rng.integers(2, cfg.vocab_size, 300).tolist()
    second = rng.integers(2, cfg.vocab_size, 200).tolist()
    runs = []
    for before in ([], [first]):
        eng = ServeEngine(params, cfg, batch_slots=1, cache_len=512,
                          prefill_mode="bulk", kv_layout="paged",
                          block_size=BS, fused_tokens=N, device=device)
        for p in before:
            eng.submit(p, max_new_tokens=20)
        req = eng.submit(second, max_new_tokens=20)
        eng.run()
        runs.append((req.output, [t.clone() for c in eng.cache
                                  if "ssm" in c for t in c.values()]))
        assert eng.state_summary()["slots_cleared"] == 1 + len(before)
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert _rel(a, b.float()) <= 1e-3
