"""The port's config copies and weight bridge against the reference.

`repro_torch.configs` must describe every registered arch exactly as
`repro.configs` does (full and reduced), and `params_from_jax` must carry
every leaf of the reference's `init_lm` tree across once, unstacked per
layer, and refuse a tree with a missing, misshapen or extra leaf.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

# tied + qk-norm, untied lm_head, ungated GELU MLP
ARCHS = ["qwen3-1.7b", "mistral-nemo-12b", "starcoder2-7b"]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(treg.REGISTRY))
def test_config_matches_reference(arch, reduced):
    t, j = treg.get(arch, reduced=reduced), jreg.get(arch, reduced=reduced)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert t.activation_dtype == getattr(torch, t.dtype)
    assert TT.paged_supported(t) and JT.paged_supported(j)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def _tree(arch):
    cfg = jreg.get(arch, reduced=True)
    return jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(1), cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_every_leaf(arch):
    cfg = treg.get(arch, reduced=True)
    tree = _tree(arch)
    params = params_from_jax(tree, cfg, device="cpu")
    assert _shapes(params) == TT.param_shapes(cfg)
    # the port's own init draws the same shapes and dtypes
    gen = torch.Generator().manual_seed(0)
    assert _shapes(TT.init_lm(gen, cfg)) == TT.param_shapes(cfg)
    n_ref = sum(a.size for a in jax.tree.leaves(tree))
    n_port = sum(t.numel() for t in _leaves(params))
    assert n_port == n_ref
    blocks = tree["blocks"][0]
    for i, layer in enumerate(params["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                      blocks["attn"]["wq"][i])
        np.testing.assert_array_equal(layer["ffn"]["w_down"].numpy(),
                                      blocks["ffn"]["w_down"][i])
    np.testing.assert_array_equal(params["embed"]["table"].numpy(),
                                  tree["embed"]["table"])
    assert ("lm_head" in params) == (not cfg.tie_embeddings)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_bridge_refuses_bad_trees():
    cfg = treg.get("qwen3-1.7b", reduced=True)
    tree = _tree("qwen3-1.7b")

    missing = dict(tree, final_norm={})
    with pytest.raises(ValueError, match="no leaf final_norm/scale"):
        params_from_jax(missing, cfg, device="cpu")

    attn = dict(tree["blocks"][0]["attn"])
    attn["wq"] = attn["wq"][:, :, :-1]
    bad_shape = dict(tree, blocks=(dict(tree["blocks"][0], attn=attn),))
    with pytest.raises(ValueError, match="blocks/0/attn/wq: shape"):
        params_from_jax(bad_shape, cfg, device="cpu")

    extra = dict(tree, lm_head=np.zeros((cfg.d_model, cfg.vocab_size)))
    with pytest.raises(ValueError, match="unused.*lm_head"):
        params_from_jax(extra, cfg, device="cpu")

    wrong_depth = dict(tree, blocks=(jax.tree.map(lambda a: a[:1],
                                                  tree["blocks"][0]),))
    with pytest.raises(ValueError, match="n_blocks"):
        params_from_jax(wrong_depth, cfg, device="cpu")
