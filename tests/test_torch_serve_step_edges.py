"""Padding and bucketing edges of the port's bulk-prefill path, case for
case the reference's tests/test_serve_step_edges.py: `bucket_len` at its
boundaries (and against the reference's at every n of 1-299 under caps 0,
1, 16, 64 and 128), and `prefill_into_cache` at degenerate prompt lengths
(1, an exact power-of-two boundary, and prompt == cache_len), each held to
the reference's cache positions and tokens on the same weights."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_host import one_torch_thread  # noqa: E402,F401
from _torch_tiny import V, jax_engine, port_engine, tiny  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.step import bucket_len as jax_bucket_len  # noqa: E402
from repro.serve.step import prefill_into_cache as jax_into  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.step import bucket_len, prefill_into_cache  # noqa: E402


@pytest.fixture(scope="module")
def model():
    return tiny()


def test_bucket_len_boundaries():
    assert [bucket_len(n, 64) for n in (1, 2, 4, 8, 16, 32, 64)] == \
        [1, 2, 4, 8, 16, 32, 64]
    assert [bucket_len(n, 64) for n in (3, 5, 9, 17, 33)] == \
        [4, 8, 16, 32, 64]
    assert bucket_len(64, 64) == 64
    assert bucket_len(65, 64) == 65
    assert bucket_len(100, 64) == 100
    assert bucket_len(1, 1) == 1
    assert bucket_len(5, 0) == 8                 # 0 = uncapped


@pytest.mark.parametrize("cap", [0, 1, 16, 64, 128])
def test_bucket_len_matches_reference(cap):
    got = [bucket_len(n, cap) for n in range(1, 300)]
    assert got == [jax_bucket_len(n, cap) for n in range(1, 300)]
    for n, b in zip(range(1, 300), got):
        assert b >= n                            # never rounds down
        assert b == n or (b & (b - 1)) == 0      # a length or a power of 2


def _port_pos(model, prompt, Sc, plen, pad_to=None):
    _, _, params, cfg = model
    toks = list(prompt) + [0] * ((pad_to or len(prompt)) - len(prompt))
    _, caches = T.forward_prefill(
        params, cfg, {"tokens": torch.tensor([toks], dtype=torch.int32)})
    cache = T.init_cache(cfg, 1, Sc, device="cpu")
    out = prefill_into_cache(cfg, caches, cache, [plen])
    return out[0]["pos"][0].numpy()


def _jax_pos(model, prompt, Sc, plen, pad_to=None):
    params, cfg, _, _ = model
    toks = list(prompt) + [0] * ((pad_to or len(prompt)) - len(prompt))
    _, caches = JT.forward_prefill(params, cfg,
                                   {"tokens": jnp.asarray([toks], jnp.int32)})
    cache = JT.init_cache(cfg, 1, Sc)
    out = jax_into(cfg, caches, cache, jnp.asarray([plen]))
    return np.asarray(out["blocks"][0]["pos"][0, 0])


def test_prefill_into_cache_masks_padding(model):
    """Padded positions land as pos = -1; real ones keep their index."""
    pos = _port_pos(model, [5, 7, 9], 16, 3, pad_to=8)
    assert list(pos[:3]) == [0, 1, 2]
    assert (pos[3:] == -1).all()
    np.testing.assert_array_equal(pos, _jax_pos(model, [5, 7, 9], 16, 3,
                                                pad_to=8))


@pytest.mark.parametrize("plen", [1, 8, 16])
def test_prefill_into_cache_boundary_lengths(model, plen):
    Sc = 16
    prompt = [(3 * i + 1) % V for i in range(plen)]
    pos = _port_pos(model, prompt, Sc, plen)
    assert sorted(p for p in pos if p >= 0) == list(range(plen))
    if plen == Sc:
        assert (pos >= 0).all()
    np.testing.assert_array_equal(pos, _jax_pos(model, prompt, Sc, plen))


@pytest.mark.parametrize("plen", [1, 8])
def test_bulk_prefill_edge_lengths_match_decode_mode(model, plen):
    prompt = [(3 * i + 1) % V for i in range(plen)]
    outs = {}
    for mode in ("bulk", "decode"):
        eng = port_engine(model, batch_slots=1, cache_len=32,
                          prefill_mode=mode)
        req = eng.submit(prompt, max_new_tokens=4)
        eng.run()
        outs[mode] = req.output
    assert outs["bulk"] == outs["decode"]
    ref = jax_engine(model, batch_slots=1, cache_len=32, prefill_mode="bulk")
    r = ref.submit(prompt, max_new_tokens=4)
    ref.run()
    assert r.output == outs["bulk"]


def test_bulk_prefill_prompt_fills_whole_table_paged(model):
    cache_len, bs = 16, 4
    prompt = [(5 * i + 2) % V for i in range(12)]
    eng = port_engine(model, batch_slots=1, cache_len=cache_len,
                      kv_layout="paged", block_size=bs, prefill_mode="bulk")
    req = eng.submit(prompt, max_new_tokens=4)           # 12 + 4 == 16
    eng.run()
    assert len(req.output) == 4 and req.error is None
    dense = port_engine(model, batch_slots=1, cache_len=cache_len,
                        prefill_mode="bulk")
    dreq = dense.submit(prompt, max_new_tokens=4)
    dense.run()
    assert req.output == dreq.output
    ref = jax_engine(model, batch_slots=1, cache_len=cache_len,
                     kv_layout="paged", block_size=bs, prefill_mode="bulk")
    r = ref.submit(prompt, max_new_tokens=4)
    ref.run()
    assert r.output == req.output
