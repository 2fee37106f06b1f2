"""The fused decode dispatch as a CUDA graph (`repro_torch.serve.graph`) on
the card: a replay gives the eager loop's tokens and pools bit for bit,
before and after the pools are reallocated, and the paged kernel's
launches are counted per replay as chip_smoke.py counts them.

Reduced qwen3-1.7b (2 layers, d 256, 4/2 heads, hd 64) in f32 with TF32
off and the port's seeded weights. Skips cleanly where torch sees no CUDA
device (the CPU suite runs the fused body eagerly,
test_torch_decode_variants.py). Imports no JAX. Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_fused_graph_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.graph import WARMUP_RUNS, FusedDecodeGraph
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
    cfg = registry.get("qwen3-1.7b", reduced=True)
    return T.init_lm(torch.Generator(device=device).manual_seed(0), cfg), cfg


def _operands(device, cfg, seed):
    """A random pool (row 0 included) and three slots: slot 0 long-lived,
    slot 1 dead, slot 2 with a budget of 2 and an EOS it may hit."""
    rng = np.random.default_rng(seed)
    P = 3 * NB + 1
    shape = (P, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = [{k: torch.as_tensor(rng.standard_normal(shape, np.float32),
                                 device=device) for k in ("k", "v")}
             for _ in range(cfg.n_layers)]
    table = np.zeros((3, NB), np.int32)
    table[0, :4] = [7, 2, 11, 5]
    table[2, :3] = [1, 3, 9]
    ints = {
        "tokens": rng.integers(0, cfg.vocab_size, (3, 1)),
        "pos": np.array([40, 0, 20]), "table": table,
        "eos": np.array([-1, -1, int(rng.integers(0, cfg.vocab_size))]),
        "steps": np.array([10, 0, 2]),
    }
    args = {k: torch.as_tensor(v.astype(np.int32), device=device)
            for k, v in ints.items()}
    args["live"] = torch.tensor([True, False, True], device=device)
    return cache, args


def _call(fn, params, cache, a):
    return fn(params, a["tokens"], a["pos"], cache, a["table"], a["eos"],
              a["live"], a["steps"])


def _same(cache_a, cache_b):
    for pa, pb in zip(cache_a, cache_b):
        for key in ("k", "v"):
            # row 0 is the null page: repeated writes, undefined winner
            assert torch.equal(pa[key][1:], pb[key][1:])


def test_replay_matches_the_eager_loop(device, model):
    """Per seed, new pools: the capture's replay and a second replay of the
    same inputs give the eager loop's outputs and pools; the graph refuses
    pools it was not captured against until release()."""
    params, cfg = model
    body = build_decode_fused(cfg, N)
    graph = FusedDecodeGraph(body)
    for seed in (0, 1):
        cache, args = _operands(device, cfg, seed)
        eager_cache = [{k: t.clone() for k, t in p.items()} for p in cache]
        want = _call(body, params, eager_cache, args)
        replay_cache = [{k: t.clone() for k, t in p.items()} for p in cache]
        for _ in range(2):
            got = _call(graph, params, replay_cache, args)
            torch.cuda.synchronize()
            for g, w in zip(got[:3], want[:3]):
                assert torch.equal(g, w)
            _same(replay_cache, eager_cache)
        with pytest.raises(RuntimeError, match="release"):
            _call(graph, params, cache, args)
        graph.release()


def test_replays_count_the_paged_launches(device, model):
    """A replay adds the kernel launches its capture recorded (n_layers x
    N); the capture itself adds none, the eager warm-up runs theirs."""
    params, cfg = model
    graph = FusedDecodeGraph(build_decode_fused(cfg, N))
    cache, args = _operands(device, cfg, 2)
    pa_ops.paged_attention.launches = 0
    _call(graph, params, cache, args)
    _call(graph, params, cache, args)
    torch.cuda.synchronize()
    per_run = cfg.n_layers * N
    assert graph.replays == 2 and graph.warmup_runs == WARMUP_RUNS
    assert pa_ops.paged_attention.launches == per_run * (2 + WARMUP_RUNS)


def test_engine_fused_graph_before_and_after_reset(device, model):
    """The fused engine on the card (every fused dispatch a replay) gives
    the single-step engine's tokens; after reset() the pools are new, the
    graph is captured again, and the tokens are the same."""
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
    graph = eng._decode_fused
    for _ in range(2):
        eng.step_times.clear()
        pa_ops.paged_attention.launches = 0
        replays0, warm0 = graph.replays, graph.warmup_runs
        assert serve(eng) == want
        torch.cuda.synchronize()
        replays = graph.replays - replays0
        warm = graph.warmup_runs - warm0
        assert replays == eng.step_times["fused"].n > 0
        assert warm == WARMUP_RUNS          # captured anew in each run
        single = eng.step_times["decode"].n if "decode" in eng.step_times \
            else 0
        assert pa_ops.paged_attention.launches == cfg.n_layers * (
            N * (replays + warm) + single)
        eng.manager.check_invariants()
        eng.reset()
        assert graph._graph is None
