"""The port's ServeEngine: continuous batching, slot isolation, and bulk
prefill against the plain decode loop, case for case the reference's
tests/test_serve_engine.py, each also held to the JAX engine's tokens on
the same weights (the reference's draw, bridged). None of these paths is
on a mesh, so every `constrain` hint on it returns its input."""
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from _torch_host import one_torch_thread  # noqa: E402,F401
from _torch_tiny import jax_engine, outputs, port_engine, tiny  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.step import build_prefill, prefill_into_cache  # noqa: E402


@pytest.fixture(scope="module")
def model():
    return tiny()


def _ints(x):
    return torch.tensor(x, dtype=torch.int32)


def _greedy_reference(model, prompt, n_new):
    """Plain decode loop, single sequence, on the port's model."""
    _, _, params, cfg = model
    cache = T.init_cache(cfg, 1, 64, device="cpu")
    for t, tok in enumerate(prompt):
        lg, cache = T.decode_step(params, cfg, _ints([[tok]]), _ints([t]),
                                  cache)
    out = []
    for i in range(n_new):
        nxt = int(torch.argmax(lg[0, -1]))
        out.append(nxt)
        lg, cache = T.decode_step(params, cfg, _ints([[nxt]]),
                                  _ints([len(prompt) + i]), cache)
    return out


def test_engine_matches_reference_single(model):
    eng = port_engine(model, batch_slots=2, cache_len=64)
    req = eng.submit([3, 1, 4, 1, 5], max_new_tokens=6)
    eng.run()
    assert req.done
    assert req.output == _greedy_reference(model, [3, 1, 4, 1, 5], 6)
    assert req.output == outputs(jax_engine(model, batch_slots=2,
                                            cache_len=64),
                                 [[3, 1, 4, 1, 5]], max_new=6)[0]


def test_engine_batch_isolation(model):
    prompts = [[1, 2, 3], [7, 8], [9, 10, 11, 12]]
    solo = [outputs(port_engine(model, batch_slots=1, cache_len=64), [p],
                    max_new=4)[0] for p in prompts]
    together = outputs(port_engine(model, batch_slots=3, cache_len=64),
                       prompts, max_new=4)
    assert together == solo
    assert together == outputs(jax_engine(model, batch_slots=3,
                                          cache_len=64), prompts, max_new=4)


def test_engine_continuous_batching_reuses_slots(model):
    eng = port_engine(model, batch_slots=2, cache_len=64)
    reqs = [eng.submit([i + 1, i + 2], max_new_tokens=3) for i in range(5)]
    done = eng.run()
    assert len(done) == 5 and all(r.done for r in reqs)
    assert all(len(r.output) == 3 for r in reqs)
    assert [r.output for r in reqs] == outputs(
        jax_engine(model, batch_slots=2, cache_len=64),
        [[i + 1, i + 2] for i in range(5)], max_new=3)


def test_bulk_prefill_matches_decode_prefill(model):
    """build_prefill + prefill_into_cache == token-by-token prefill."""
    _, _, params, cfg = model
    prompt = [5, 6, 7, 8]
    nxt, nat = build_prefill(cfg)(params, {"tokens": _ints([prompt])})
    cache = T.init_cache(cfg, 1, 32, device="cpu")
    cache = prefill_into_cache(cfg, nat, cache, [len(prompt)])
    lg, _ = T.decode_step(params, cfg, _ints([[int(nxt[0])]]),
                          _ints([len(prompt)]), cache)
    ref_out = _greedy_reference(model, prompt, 2)
    assert int(nxt[0]) == ref_out[0]
    assert int(torch.argmax(lg[0, -1])) == ref_out[1]


def test_bulk_prefill_engine_matches_decode_prefill_engine(model):
    prompts = [[3, 1, 4], [15, 9, 2, 6]]
    outs = {mode: outputs(port_engine(model, batch_slots=2, cache_len=64,
                                      prefill_mode=mode), prompts)
            for mode in ("decode", "bulk")}
    assert outs["bulk"] == outs["decode"]
    assert outs["bulk"] == outputs(jax_engine(model, batch_slots=2,
                                              cache_len=64,
                                              prefill_mode="bulk"), prompts)
