"""The port's checkpoints: the reference's test_checkpoint.py case for case
on the port (round trip of params and optimizer state with dtypes and
shapes, latest-step discovery, the trainer writing checkpoints), and files
read across the two packages in both directions: the trainer's {"params",
"opt_state"} in the reference's layout on reduced qwen3-1.7b,
recurrentgemma-9b and mamba2-130m, and bfloat16 leaves, which `np.savez`
stores as raw 2-byte records. Values must be equal, bit for bit."""
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.checkpoint import (latest_step, load_flat,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.params import jax_layout, params_from_jax  # noqa: E402
from repro_torch.train.trainer import (checkpoint_tree,  # noqa: E402
                                       restore_train_state)
from _torch_parity import bridged_model  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = ["qwen3-1.7b", "recurrentgemma-9b", "mamba2-130m"]


# ---- the reference's cases

def test_roundtrip_nested_tree(tmp_path):
    cfg = ModelConfig("t", "dense", 2, 32, 2, 2, 64, 17)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    opt_init, _ = adamw(1e-3)
    state = {"params": params, "opt": opt_init(params),
             "step": torch.tensor(7)}
    save_checkpoint(str(tmp_path), 7, state)
    assert latest_step(str(tmp_path)) == 7
    like = tree_map(torch.zeros_like, state)
    restored = restore_checkpoint(str(tmp_path), 7, like)
    assert type(restored["opt"]) is type(state["opt"])
    for a, b in zip(tree_flatten(state)[0], tree_flatten(restored)[0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_multiple_steps_latest(tmp_path):
    tree = {"w": torch.ones(3)}
    for s in (5, 20, 10):
        save_checkpoint(str(tmp_path), s, tree)
    assert latest_step(str(tmp_path)) == 20


def test_trainer_writes_checkpoints(tmp_path):
    from repro_torch.train.trainer import train_loop
    from repro_torch.configs.base import MLPConfig
    from repro_torch.models.dnn import dnn_loss, init_dnn
    from repro_torch.train.step import build_dnn_train_step
    cfg = MLPConfig(n_features=4, n_classes=2, hidden_sizes=(8,))
    params = init_dnn(torch.Generator().manual_seed(0), cfg)
    opt_init, opt_update = adamw(1e-3)
    step = build_dnn_train_step(cfg, opt_update, dnn_loss)

    def data():
        g = torch.Generator().manual_seed(1)
        while True:
            yield {"x": torch.randn((8, 4), generator=g),
                   "y": torch.nn.functional.one_hot(
                       torch.zeros(8, dtype=torch.long), 2).float()}

    p, o, log = train_loop(step, params, opt_init(params), data(),
                           num_steps=4, log_every=2,
                           ckpt_dir=str(tmp_path), ckpt_every=2,
                           verbose=False)
    assert latest_step(str(tmp_path)) == 4
    assert len(log.losses) >= 2



def test_restore_lands_on_the_template_devices(tmp_path):
    """With no device given, each restored leaf goes where its template
    leaf lives: params on another device (here `meta`) restore there, and
    AdamW's step counter stays on the CPU where `adamw` keeps it. An
    explicit device wins."""
    from repro_torch.train.trainer import restore_train_state
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    opt_init, _ = adamw(1e-3)
    save_checkpoint(str(tmp_path), 1, {"params": params,
                                       "opt_state": opt_init(params)})
    meta = tree_map(lambda t: t.to("meta"), params)
    p, opt = restore_train_state(str(tmp_path), 1, meta, opt_init(meta))
    assert {t.device.type for t in tree_flatten((p, opt.mu, opt.nu))[0]} \
        == {"meta"}
    assert opt.step.device.type == "cpu"
    tree = restore_checkpoint(str(tmp_path), 1, {"params": meta})
    assert {t.device.type for t in tree_flatten(tree)[0]} == {"meta"}
    p, opt = restore_train_state(str(tmp_path), 1, meta, opt_init(meta),
                                 device="cpu")
    assert {t.device.type for t in tree_flatten((p, opt))[0]} == {"cpu"}
    assert torch.equal(p["w"], params["w"])

# ---- across the packages

def _jax_trained_state(jcfg, jp):
    """Params and AdamW state after one update with nonzero gradients."""
    jinit, jupdate = jax_adamw(1e-3)
    grads = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype)
                         + 1e-3 * a, jp)
    return jupdate(grads, jinit(jp), jp)[:2]


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    jcfg, tcfg, jp, tp = bridged_model(arch)
    jparams, jopt = _jax_trained_state(jcfg, jp)
    jax_save(str(tmp_path), 3, {"params": jparams, "opt_state": jopt})
    init, _ = adamw(1e-3)
    params, opt = restore_train_state(str(tmp_path), 3, tp, init(tp), tcfg)
    want = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu")
    for a, b in zip(tree_flatten(params)[0], tree_flatten(want)[0]):
        assert torch.equal(a, b)
    assert int(opt.step) == 1
    got = checkpoint_tree(params, opt, tcfg)["opt_state"]
    for field in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(getattr(got, field)),
                        jax.tree.leaves(getattr(jopt, field))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    jcfg, tcfg, jp, tp = bridged_model(arch)
    params = tree_map(torch.clone, tp)
    init, update = adamw(1e-3)
    grads = tree_map(lambda p: 0.01 + 1e-3 * p, params)
    params, opt, _ = update(grads, init(params), params)
    save_checkpoint(str(tmp_path), 9, checkpoint_tree(params, opt, tcfg))
    jinit, _ = jax_adamw(1e-3)
    restored = jax_restore(str(tmp_path), 9, {"params": jp,
                                              "opt_state": jinit(jp)})
    ours = checkpoint_tree(params, opt, tcfg)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert jax.tree.structure(restored) == jax.tree.structure(
        {"params": jp, "opt_state": jinit(jp)})
    # the reference's own init tree and the port's layout give the same keys
    assert sorted(_keys(jax_layout(tp, tcfg))) == sorted(_keys(jp))


def _keys(tree):
    from repro_torch.checkpoint.checkpoint import _items
    return [k for k, _ in _items(tree, "")]


def test_bfloat16_leaves_cross_both_ways(tmp_path):
    vals = np.array([[1.5, -2.25, 3.0], [0.1, 1e-3, -7.0]], np.float32)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    jax_save(str(ref_dir), 1, {"w": jnp.asarray(vals, jnp.bfloat16),
                               "n": {"s": jnp.ones(2)},
                               "step": jnp.asarray(4, jnp.int32)})
    flat = load_flat(str(ref_dir), 1)
    assert flat["w"].dtype == torch.bfloat16
    assert torch.equal(flat["w"], torch.tensor(vals).to(torch.bfloat16))
    assert flat["step"].dtype == torch.int32 and int(flat["step"]) == 4

    save_checkpoint(str(port_dir), 1, {"w": torch.tensor(vals).to(
        torch.bfloat16), "n": {"s": torch.ones(2)}})
    like = {"w": np.zeros((2, 3)), "n": {"s": np.zeros(2)}}
    back = jax_restore(str(port_dir), 1, like)
    assert back["w"].dtype == np.dtype("V2")     # as its own bf16 files
    np.testing.assert_array_equal(back["w"].view(ml_dtypes.bfloat16),
                                  vals.astype(ml_dtypes.bfloat16))
    import json
    manifest = json.loads((port_dir / "step_00000001.manifest.json")
                          .read_text())
    ref_manifest = json.loads((ref_dir / "step_00000001.manifest.json")
                              .read_text())
    assert manifest["dtypes"]["w"] == ref_manifest["dtypes"]["w"]


def test_bfloat16_model_checkpoint_from_the_reference(tmp_path):
    jcfg, tcfg, _, _ = bridged_model("qwen3-1.7b")
    jcfg, tcfg = (c.replace(param_dtype="bfloat16") for c in (jcfg, tcfg))
    from repro.models import transformer as JT
    jp = jax.jit(JT.init_lm, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    jax_save(str(tmp_path), 2, {"params": jp})
    template = T.init_lm(torch.Generator().manual_seed(0), tcfg)
    restored = restore_checkpoint(str(tmp_path), 2,
                                  {"params": jax_layout(template, tcfg)})
    params = params_from_jax(restored["params"], tcfg, device="cpu")
    want = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    for a, b in zip(tree_flatten(params)[0], tree_flatten(want)[0]):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)
