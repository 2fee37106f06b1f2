"""The MoE decode on the card: the fused decode dispatch of an MoE model
(`serve/graph.py`'s CUDA graph over `build_decode_fused`) captures and
replays with no host synchronisation anywhere in its body
(`torch.cuda.set_sync_debug_mode("error")` around the capture and the
replays), and gives the eager body's tokens and pools; each replay adds its
captured launches to the paged-attention and grouped MoE experts counters
(a decode position's dispatch group keeps every entry, so each layer's MoE
runs the grouped kernel); the fused engine gives the single-step engine's
tokens.

Reduced granite-moe-1b-a400m (2 layers, d 256, 4 experts top-2) in f32
with TF32 off and the port's seeded weights. Skips where torch sees no
CUDA device. Imports no JAX. Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_moe_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels.moe_experts import ops as me_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.graph import FusedDecodeGraph
from repro_torch.serve.step import build_decode_fused

pytestmark = pytest.mark.gpu

BS, NB, N = 16, 8, 4
PROMPTS = [[3, 1, 4, 3, 1, 4, 3, 1], [3, 1, 4, 3, 7], [9, 10, 11, 12],
           [5, 5, 5, 5, 5, 5], [3, 1, 4, 3, 1, 4, 9, 9, 2]]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph and the paged kernel "
                    "have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(device):
    cfg = registry.get("granite-moe-1b-a400m", reduced=True)
    return T.init_lm(torch.Generator(device=device).manual_seed(0), cfg), cfg


def _operands(device, cfg, seed):
    """A random pool and three slots: slot 0 long-lived, slot 1 dead,
    slot 2 with a budget of 2."""
    rng = np.random.default_rng(seed)
    shape = (3 * NB + 1, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = [{k: torch.as_tensor(rng.standard_normal(shape, np.float32),
                                 device=device) for k in ("k", "v")}
             for _ in range(cfg.n_layers)]
    table = np.zeros((3, NB), np.int32)
    table[0, :4] = [7, 2, 11, 5]
    table[2, :3] = [1, 3, 9]
    ints = {"tokens": rng.integers(0, cfg.vocab_size, (3, 1)),
            "pos": np.array([40, 0, 20]), "table": table,
            "eos": np.array([-1, -1, -1]), "steps": np.array([10, 0, 2])}
    args = {k: torch.as_tensor(v.astype(np.int32), device=device)
            for k, v in ints.items()}
    args["live"] = torch.tensor([True, False, True], device=device)
    return cache, args


def _call(fn, params, cache, a):
    return fn(params, a["tokens"], a["pos"], cache, a["table"], a["eos"],
              a["live"], a["steps"])


def test_fused_moe_decode_captures_and_replays_without_a_sync(device,
                                                             model):
    params, cfg = model
    body = build_decode_fused(cfg, N)
    graph = FusedDecodeGraph(body)
    cache, args = _operands(device, cfg, 0)
    eager_cache = [{k: t.clone() for k, t in p.items()} for p in cache]
    want = _call(body, params, eager_cache, args)
    torch.cuda.synchronize()
    pa_ops.paged_attention.launches = 0
    me_ops.moe_experts.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [_call(graph, params, cache, args) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert graph.captures == 1 and graph.replays == 2
    for got in outs:
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w)
    for pa, pb in zip(cache, eager_cache):
        for key in ("k", "v"):
            # row 0 is the null page: repeated writes, undefined winner
            assert torch.equal(pa[key][1:], pb[key][1:])
    assert pa_ops.paged_attention.launches == cfg.n_layers * N * (
        2 + graph.warmup_runs)
    assert me_ops.moe_experts.launches == cfg.n_layers * N * (
        2 + graph.warmup_runs)


def test_fused_moe_engine_gives_the_single_steps_tokens(device, model):
    params, cfg = model
    kw = dict(batch_slots=2, cache_len=NB * BS, kv_layout="paged",
              block_size=BS, prefill_mode="bulk", device=device)

    def serve(eng):
        reqs = [eng.submit(p, max_new_tokens=5 + 3 * i)
                for i, p in enumerate(PROMPTS)]
        eng.run()
        assert all(r.done and r.error is None for r in reqs)
        return [r.output for r in reqs]

    want = serve(ServeEngine(params, cfg, **kw))
    eng = ServeEngine(params, cfg, fused_tokens=N, **kw)
    assert serve(eng) == want
    assert eng._decode_fused.replays == eng.step_times["fused"].n > 0
