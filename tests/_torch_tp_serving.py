"""The checks of the tensor-parallel serving tests
(tests/test_torch_tensor_parallel_serving.py,
tests/test_torch_tensor_parallel_serving_families.py and
tests/test_torch_tensor_parallel_serving_recurrent.py): the reference's
greedy tokens on one device, the port's one-device steps, the ranks'
runs (`_torch_tp.serve_ranks`) and what each test holds them to.
Imported only by test files that have already done
``pytest.importorskip("jax")``.

All-reduces over "model" a call (L attention layers, Le encoder layers,
Lr RG-LRU layers, Lm Mamba2 layers; c = 1 for an encoder-decoder; g the
leaves stored split and taken whole, one all-reduce each in serving,
having no gradient: where the kv heads do not split wk and wv of every
attention, and Mamba2's in_proj and conv_w, stored split by contiguous
columns, in every layer):
  prefill     (2 + c) L + 2 Le + 4 Lr + 3 Lm + 2 + g (the forward's
              row-parallel outputs, an RG-LRU layer's conv gather and
              new state's gather besides, a Mamba2 layer's norm, output
              and state, the embedding, the greedy token), and 2 (1 + c)
              L all-to-alls (k, v to head_dim) where the kv heads split
              (else each rank holds every kv head and slices it); by the
              all-reduce route (the card rig's) those are all-reduces
  handoff     tp (1 + c) L (`prefill_into_cache_split`: a block of slots
              a rank, k and v together; a recurrent state is whole on
              every rank and copied as it is)
  decode      (4 + 3 c) L + 4 Lr + 3 Lm + 2 + g (a self-attention's
              gather, merge and output, a cross-attention's the same, the
              FFN's or MoE's output, an RG-LRU or Mamba2 layer's as in the
              prefill, the embedding, the greedy token; g counts the
              encoder's leaves too: they are arguments of the step)
"""
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_tp as H
from _torch_dist import spawn
from _torch_parity import bridged_model
from repro_torch.configs import registry

LOGIT_TOL = 1e-5         # of the one-device logits' max |value|, a step
CACHE_TOL = 1e-5         # of each cache leaf's max |value|
NAMES = ("pod", "data", "model")


def close(a, b, tol, what):
    scale = max(float(b.abs().max()), 1e-30)
    err = float((a.float() - b.float()).abs().max())
    assert err <= tol * scale, f"{what}: {err:.3g} of {scale:.3g}"


@functools.cache
def reference_serve(arch, cache_len=H.SERVE_CACHE) -> np.ndarray:
    """The reference's greedy tokens on one device: `build_prefill`,
    `prefill_into_cache` into `cache_len` slots and SERVE_STEPS
    `build_decode` steps, (SERVE_STEPS + 1, B)."""
    from repro.models import transformer as JT
    from repro.serve.step import build_decode, build_prefill
    from repro.serve.step import prefill_into_cache
    jcfg, cfg, jp, _ = bridged_model(arch)
    batch = {k: jnp.asarray(v) for k, v in H.serve_batch(cfg).items()}
    tok, nat = jax.jit(build_prefill(jcfg))(jp, batch)
    n = H.serve_prompt_len(cfg)
    cache = prefill_into_cache(jcfg, nat, JT.init_cache(
        jcfg, H.SERVE_ROWS, cache_len,
        enc_len=H.SERVE_FRAMES if cfg.is_encdec else 0),
        jnp.full((H.SERVE_ROWS,), n))
    decode = jax.jit(build_decode(jcfg))
    toks = [np.asarray(tok)]
    for i in range(H.SERVE_STEPS):
        tok, cache = decode(jp, tok[:, None],
                            jnp.full((H.SERVE_ROWS,), n + i, jnp.int32),
                            cache)
        toks.append(np.asarray(tok))
    return np.stack(toks)


def bridged_params(archs, tmp_path_factory):
    """The reference's reduced weights of `archs`, bridged, and the path
    of their pickle for the ranks."""
    params = {a: bridged_model(a)[3] for a in archs}
    path = tmp_path_factory.mktemp("serve") / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(params, f)
    return params, str(path)


def one_device_runs(params, cache_lens=None) -> dict:
    out = {}
    for a, p in params.items():
        cfg = registry.get(a, reduced=True)
        out[a] = H.serve_one_device(cfg, p, H.serve_batch(cfg),
                                    (cache_lens or {}).get(a, H.SERVE_CACHE))
    return out


def mesh_run(shape, archs, params_path, tmp, cache_lens=None):
    return shape, archs, spawn(H.serve_ranks, int(np.prod(shape)), tmp,
                               params_path, archs, shape, NAMES, cache_lens)


def expected_counts(cfg, size: int, kv_split: bool) -> dict:
    """(all-reduces, all-to-alls) of every call: the module docstring (every
    recurrent part split)."""
    types = cfg.layer_types()
    L, c = types.count("attn"), int(cfg.is_encdec)
    Lr, Lm = types.count("rglru"), types.count("ssm")
    Le = cfg.n_enc_layers if cfg.is_encdec else 0
    g = (0 if kv_split else 2 * (L + c * (L + Le))) + 2 * Lm
    moves = 2 * (1 + c) * L if kv_split else 0
    prefill = (2 + c) * L + 2 * Le + 4 * Lr + 3 * Lm + 2 + g
    decode = (4 + 3 * c) * L + 4 * Lr + 3 * Lm + 2 + g
    return {"prefill": (prefill, moves), "prefill_logits": (prefill, moves),
            "prefill_all_reduce_route": (prefill + moves, 0),
            "handoff": (size * (1 + c) * L, 0),
            "decode": (decode, 0), "decode_logits": (decode, 0)}


def check_one_device_tokens(one_device, arch):
    assert np.array_equal(one_device[arch]["tokens"].numpy(),
                          reference_serve(arch, one_device[arch]["cache_len"]))


def check_tokens(runs):
    shape, archs, ranks = runs
    for arch in archs:
        want = reference_serve(arch, ranks[0][arch]["cache_len"])
        for r, res in enumerate(ranks):
            assert np.array_equal(res[arch]["tokens"].numpy(), want), \
                (arch, shape, r)


def check_logits(runs, one_device):
    shape, archs, ranks = runs
    for arch in archs:
        want = one_device[arch]["logits"]
        for r, res in enumerate(ranks):
            got = res[arch]["logits"]
            assert got.shape == want.shape
            for i in range(got.shape[0]):
                close(got[i], want[i], LOGIT_TOL,
                      f"{arch} {shape} rank {r} step {i}")


def check_caches(runs, one_device):
    """The prefill caches (head_dim over "model"), the decode caches right
    after `prefill_into_cache_split` and after the steps, gathered, against
    one device's; the all-reduce route's prefill caches equal the
    all-to-all's."""
    shape, archs, ranks = runs
    for arch in archs:
        res, want = ranks[0][arch], one_device[arch]
        for name in ("prefill_caches", "handed", "caches"):
            for got_l, want_l in zip(res[name], want[name]):
                assert set(got_l) == set(want_l), (arch, name)
                for k in want_l:
                    if "pos" in k:
                        assert torch.equal(got_l[k], want_l[k]), (arch, k)
                    else:
                        close(got_l[k], want_l[k], CACHE_TOL,
                              f"{arch} {shape} {name} {k}")
        assert all(r[arch]["all_reduce_route_equal"] for r in ranks), arch


def check_counts(runs):
    shape, archs, ranks = runs
    for arch in archs:
        cfg = registry.get(arch, reduced=True)
        for res in ranks:
            kv_split = res[arch]["split"][1]
            assert kv_split == (cfg.n_kv_heads % shape[-1] == 0)
            want = expected_counts(cfg, shape[-1], kv_split)
            got = res[arch]["counts"]
            assert set(got) == set(want), arch
            for name, per_call in got.items():
                assert set(per_call) == {want[name]}, (arch, name, per_call)


def check_no_full_cache_or_logits(runs):
    """Every rank holds its cache_len / tp slots of every attention layer
    (its SERVE_FRAMES / tp cross slots) and each recurrent layer's whole
    state for its rows (the reference's layout), no op output of a
    greedy prefill, the handoff or a greedy decode step is an attention
    layer's full-length cache, and every rank's logits are its (..., V /
    tp) slice (`transformer._logits`)."""
    from repro_torch.models import transformer as T
    shape, archs, ranks = runs
    tp = shape[-1]
    for arch in archs:
        cfg = registry.get(arch, reduced=True)
        n = ranks[0][arch]["cache_len"]
        whole = T.init_cache(cfg, H.SERVE_ROWS, n, device="meta")
        for res in ranks:
            assert res[arch]["cache_split"] == (
                "attn" in cfg.layer_types(), cfg.is_encdec)
            for layer, want in zip(res[arch]["local_cache"], whole):
                if "k" not in layer:
                    for k, s in layer.items():
                        rows = H.SERVE_ROWS * tp // int(np.prod(shape))
                        assert s == (rows,) + tuple(want[k].shape[1:]), k
                    continue
                assert layer["k"][1] == n // tp
                assert layer["pos"][1] == n // tp
                if cfg.is_encdec:
                    assert layer["cross_k"][1] == H.SERVE_FRAMES // tp
            for name, shapes in res[arch]["shapes"].items():
                assert shapes, name
                for s in shapes:
                    assert not (len(s) >= 2 and s[1] == n), (arch, name, s)
            logits = res[arch]["logits_shapes"]
            assert logits and {s[-1] for s in logits} == {
                cfg.padded_vocab_size // tp}, logits
