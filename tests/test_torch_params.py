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
    assert TT.paged_supported(t) == JT.paged_supported(j)


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


def test_bridge_keeps_rglru_f32_leaves_and_uses_every_tail_leaf():
    """Under a bf16 config the RG-LRU's b_r, b_i and Lambda stay float32
    (the reference's init keeps them so) and every other leaf is bf16; a
    hybrid with a tail has every block and tail leaf carried across once,
    in layer order blocks then tail."""
    from repro.configs.base import ModelConfig as JaxConfig
    from repro.configs.base import RGLRUConfig as JaxRGLRU
    from repro_torch.configs.base import ModelConfig, RGLRUConfig
    kw = dict(arch_id="h", family="hybrid", n_layers=5, d_model=64,
              n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=97,
              block_pattern=("rglru", "rglru", "attn"),
              tail_pattern=("rglru", "rglru"), window=8,
              dtype="bfloat16", param_dtype="bfloat16")
    jcfg = JaxConfig(**kw, rglru=JaxRGLRU(lru_width=64))
    tcfg = ModelConfig(**kw, rglru=RGLRUConfig(lru_width=64))
    tree = jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(2), jcfg))
    params = params_from_jax(tree, tcfg, device="cpu")
    assert _shapes(params) == TT.param_shapes(tcfg)
    assert [("rglru" in layer) for layer in params["layers"]] == \
        [t == "rglru" for t in tcfg.layer_types()]
    n_ref = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in _leaves(params)) == n_ref
    for layer in params["layers"]:
        for name, t in layer.get("rglru", {}).items():
            want = torch.float32 if name in ("b_r", "b_i", "Lambda") \
                else torch.bfloat16
            assert t.dtype == want, name
        assert layer["ffn"]["w_up"].dtype == torch.bfloat16
    # tail layer i is the reference's tail[i], block layers unstack
    np.testing.assert_array_equal(
        params["layers"][4]["rglru"]["Lambda"].numpy(),
        tree["tail"][1]["rglru"]["Lambda"])
    np.testing.assert_array_equal(
        params["layers"][3]["rglru"]["w_r"].float().numpy(),
        tree["tail"][0]["rglru"]["w_r"].astype(np.float32))
    np.testing.assert_array_equal(
        params["layers"][1]["rglru"]["b_i"].numpy(),
        tree["blocks"][1]["rglru"]["b_i"][0])
    # the port's own init draws the same dtypes
    own = TT.init_lm(torch.Generator().manual_seed(0), tcfg)
    assert own["layers"][0]["rglru"]["Lambda"].dtype == torch.float32
    assert own["layers"][0]["rglru"]["w_x"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_mamba2_and_keeps_its_f32_leaves(dtype):
    """Reduced mamba2-130m: every leaf carried across once, unstacked per
    layer into {"norm1", "mamba"} (no FFN); under a bf16 config A_log and
    dt_bias stay float32 (the reference's init keeps them so) and every
    other leaf is bf16."""
    jcfg = jreg.get("mamba2-130m", reduced=True).replace(
        dtype=dtype, param_dtype=dtype)
    tcfg = treg.get("mamba2-130m", reduced=True).replace(
        dtype=dtype, param_dtype=dtype)
    tree = jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(3), jcfg))
    params = params_from_jax(tree, tcfg, device="cpu")
    assert _shapes(params) == TT.param_shapes(tcfg)
    assert sum(t.numel() for t in _leaves(params)) == \
        sum(a.size for a in jax.tree.leaves(tree))
    pdt = getattr(torch, dtype)
    for i, layer in enumerate(params["layers"]):
        assert set(layer) == {"norm1", "mamba"}
        for name, t in layer["mamba"].items():
            want = torch.float32 if name in ("A_log", "dt_bias") else pdt
            assert t.dtype == want, name
            np.testing.assert_array_equal(
                t.float().numpy(),
                tree["blocks"][0]["mamba"][name][i].astype(np.float32))
    # the port's own init draws the same shapes and dtypes
    own = TT.init_lm(torch.Generator().manual_seed(0), tcfg)
    assert _shapes(own) == TT.param_shapes(tcfg)
    assert own["layers"][0]["mamba"]["A_log"].dtype == torch.float32
    assert own["layers"][0]["mamba"]["dt_bias"].dtype == torch.float32
    assert own["layers"][0]["mamba"]["in_proj"].dtype == pdt


# ---- the paper's MLPs: one, or a population stacked on a leading axis

def _mlp_tree(stacked):
    from repro.configs.base import MLPConfig as JMLPConfig
    from repro.models.dnn import init_dnn
    jcfg = JMLPConfig(n_features=6, n_classes=3, hidden_sizes=(16, 8))
    if stacked:
        keys = jax.numpy.stack([jax.random.PRNGKey(s) for s in (0, 4, 9)])
        tree = jax.vmap(lambda k: init_dnn(k, jcfg))(keys)
    else:
        tree = init_dnn(jax.random.PRNGKey(0), jcfg)
    return jax.tree.map(np.asarray, tree)


def _mlp_cfg():
    from repro_torch.configs.base import MLPConfig
    return MLPConfig(n_features=6, n_classes=3, hidden_sizes=(16, 8))


@pytest.mark.parametrize("stacked", [False, True], ids=["one", "population"])
def test_bridge_carries_an_mlp(stacked):
    tree = _mlp_tree(stacked)
    params = params_from_jax(tree, _mlp_cfg(), device="cpu")
    assert isinstance(params["layers"], tuple) and len(params["layers"]) == 3
    for lp, lj in zip(params["layers"], tree["layers"]):
        assert set(lp) == {"w", "b"}
        for k in ("w", "b"):
            assert lp[k].dtype == torch.float32
            np.testing.assert_array_equal(lp[k].numpy(), lj[k])


@pytest.mark.parametrize("fault", ["missing", "shape", "extra", "members"])
def test_bridge_refuses_a_bad_mlp_tree(fault):
    tree = _mlp_tree(stacked=fault == "members")
    layers = [dict(lp) for lp in tree["layers"]]
    if fault == "missing":
        del layers[1]["b"]
    elif fault == "shape":
        layers[2]["w"] = layers[2]["w"][:, :2]
    elif fault == "extra":
        layers.append({"w": np.zeros((3, 3), np.float32),
                       "b": np.zeros(3, np.float32)})
    else:                                       # member counts disagree
        layers[1]["b"] = layers[1]["b"][:2]
    with pytest.raises(ValueError):
        params_from_jax({"layers": tuple(layers)}, _mlp_cfg(), device="cpu")
