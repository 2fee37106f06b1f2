"""The port's training path against the reference's, float32 on the CPU,
with the reference's own weights bridged over: `forward_train`, the
gradients of `lm_loss`, `build_lm_train_step` with AdamW over five steps,
microbatch accumulation and remat, the MLP's `build_dnn_train_step`, and
the kernels' refusal of a backward, on reduced qwen3-1.7b,
recurrentgemma-9b (one r, r, a block) and mamba2-130m (two ssm layers).

Tolerances: logits 1e-5; each gradient leaf within 1e-4 of that leaf's
largest absolute gradient (sums taken in another order through a few
layers); losses over five AdamW steps 1e-4; remat's gradients 1e-6 (the
same arithmetic recomputed). `bridged_model` is shared by the process, so
every test that trains copies the params first.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils._pytree import tree_map, tree_unflatten, tree_flatten  # noqa: E402

from repro.configs.base import MLPConfig as JaxMLPConfig  # noqa: E402
from repro.data.tokens import TokenStream as JaxTokenStream  # noqa: E402
from repro.models import dnn as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train.losses import lm_loss as jax_lm_loss  # noqa: E402
from repro.train.step import build_dnn_train_step as jax_dnn_step  # noqa: E402
from repro.train.step import build_lm_train_step as jax_lm_step  # noqa: E402
from repro_torch.configs.base import MLPConfig, ModelConfig  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.models import dnn as TD  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.params import jax_layout, params_from_jax  # noqa: E402
from repro_torch.train.losses import lm_loss  # noqa: E402
from repro_torch.train.step import (build_dnn_train_step,  # noqa: E402
                                    build_lm_train_step, value_and_grad)
from _torch_parity import bridged_model, to_np  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = ["qwen3-1.7b", "recurrentgemma-9b", "mamba2-130m"]
B, S = 4, 32


def _batch(cfg, seed=0, b=B, s=S):
    return JaxTokenStream(cfg.vocab_size, s, b, seed=seed).next_batch()


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _copy(tree):
    return tree_map(torch.clone, tree)


def _flat(tree, prefix=()):
    """{path: numpy array} over nested dicts and sequences."""
    if isinstance(tree, dict):
        return {p: a for k, v in tree.items()
                for p, a in _flat(v, prefix + (k,)).items()}
    if isinstance(tree, (tuple, list)):
        return {p: a for i, v in enumerate(tree)
                for p, a in _flat(v, prefix + (i,)).items()}
    return {prefix: to_np(tree)}


def _port_grads(params, tcfg, batch):
    _, spec = tree_flatten(params)
    _, _, grads = value_and_grad(
        lambda p, mb: lm_loss(p, tcfg, mb, TT.forward_train), params, batch)
    return tree_unflatten(grads, spec)


def _jax_grads(jparams, jcfg, batch):
    return jax.grad(lambda p: jax_lm_loss(p, jcfg, batch,
                                          JT.forward_train)[0])(jparams)


def _leafwise_close(port_tree, jax_tree, rel):
    fp, fj = _flat(port_tree), _flat(jax_tree)
    assert set(fp) == set(fj)
    for path, j in fj.items():
        scale = max(float(np.abs(j).max()), 1e-12)
        err = float(np.abs(fp[path] - j).max())
        assert err <= rel * scale, (path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_logits_match_reference(arch):
    jcfg, tcfg, jp, tp = bridged_model(arch)
    batch = _batch(tcfg)
    logits, aux = TT.forward_train(tp, tcfg, _t(batch))
    jlogits, jaux = JT.forward_train(jp, jcfg, _j(batch))
    assert logits.shape == (B, S, tcfg.padded_vocab_size)
    np.testing.assert_allclose(to_np(logits), to_np(jlogits), atol=1e-5,
                               rtol=1e-5)
    assert set(aux) == set(jaux)
    for k in aux:
        assert float(aux[k]) == float(jaux[k]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    jcfg, tcfg, jp, tp = bridged_model(arch)
    batch = _batch(tcfg, seed=1)
    grads = _port_grads(tp, tcfg, _t(batch))
    assert all(not p.requires_grad for p in tree_flatten(tp)[0])
    _leafwise_close(jax_layout(grads, tcfg), _jax_grads(jp, jcfg,
                                                        _j(batch)), 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    _, tcfg, _, tp = bridged_model(arch)
    batch = _t(_batch(tcfg, seed=2))
    plain = _port_grads(tp, tcfg, batch)
    remat = _port_grads(tp, tcfg.replace(remat=True), batch)
    for a, b in zip(tree_flatten(plain)[0], tree_flatten(remat)[0]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_five_adamw_steps_match_reference(arch):
    jcfg, tcfg, jp, tp = bridged_model(arch)
    params = _copy(tp)
    init, update = adamw(1e-3)
    jinit, jupdate = jax_adamw(1e-3)
    step = build_lm_train_step(tcfg, update)
    jstep = jax.jit(jax_lm_step(jcfg, jupdate))
    opt, jopt, jparams = init(params), jinit(jp), jp
    stream = JaxTokenStream(tcfg.vocab_size, S, B, seed=3)
    for _ in range(5):
        b = stream.next_batch()
        params, opt, m = step(params, opt, _t(b))
        jparams, jopt, jm = jstep(jparams, jopt, _j(b))
        assert set(m) == set(jm)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4, \
            (float(m["loss"]), float(jm["loss"]))
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert int(opt.step) == int(jopt.step) == 5
    assert all(not p.requires_grad for p in tree_flatten(params)[0])


def test_microbatches_match_reference():
    jcfg, tcfg, jp, tp = bridged_model("qwen3-1.7b")
    batch = _batch(tcfg, seed=4, b=8, s=16)
    init, update = adamw(1e-3, clip_norm=None)
    jinit, jupdate = jax_adamw(1e-3, clip_norm=None)
    params, _, m = build_lm_train_step(tcfg, update, microbatches=4)(
        _copy(tp), init(tp), _t(batch))
    jparams, _, jm = jax.jit(jax_lm_step(jcfg, jupdate, microbatches=4))(
        jp, jinit(jp), _j(batch))
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-5,
                                   rtol=1e-4)
    # parameters after one step: the reference's own microbatch tolerance
    # (Adam's normalised step magnifies a near-zero gradient's rounding)
    fp, fj = _flat(jax_layout(params, tcfg)), _flat(jparams)
    for path, j in fj.items():
        np.testing.assert_allclose(fp[path], j, atol=5e-4, rtol=5e-3,
                                   err_msg=str(path))


# ---- the reference's test_train_integration.py, first two cases, on the port

def _cfg():
    return ModelConfig("t", "dense", 2, 64, 4, 2, 128, 256)


def test_lm_loss_decreases():
    cfg = _cfg()
    params = TT.init_lm(torch.Generator().manual_seed(0), cfg)
    opt_init, opt_update = adamw(1e-2, weight_decay=0.0)
    opt_state = opt_init(params)
    step = build_lm_train_step(cfg, opt_update)
    # low-branching Markov stream: strong learnable signal in few steps
    stream = TokenStream(cfg.vocab_size, 32, 32, seed=0, branch=4)
    losses = []
    for i, b in zip(range(50), stream):
        params, opt_state, m = step(params, opt_state, _t(b))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::10]
    assert np.isfinite(losses).all()


def test_grad_accumulation_equivalence():
    """microbatches=4 produces (approximately) the same update as
    microbatches=1 on the same global batch."""
    cfg = _cfg()
    params = TT.init_lm(torch.Generator().manual_seed(0), cfg)
    opt_init, opt_update = adamw(1e-3, clip_norm=None)
    batch = _t(TokenStream(cfg.vocab_size, 16, 8, seed=1).next_batch())
    outs = []
    for mb in (1, 4):
        step = build_lm_train_step(cfg, opt_update, microbatches=mb)
        p2, _, m = step(_copy(params), opt_init(params), batch)
        outs.append((p2, float(m["loss"])))
    (p_a, l_a), (p_b, l_b) = outs
    assert abs(l_a - l_b) < 1e-3
    for a, b in zip(tree_flatten(p_a)[0], tree_flatten(p_b)[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4,
                                   rtol=5e-3)


# ---- the paper's MLP

MLP_KW = dict(n_features=12, n_classes=4, hidden_sizes=(32, 16),
              activations=("relu", "tanh"))


def _mlp_batches(n=5, bs=16):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        x = rng.standard_normal((bs, 12), np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, bs)]
        out.append({"x": x, "y": y})
    return out


def test_dnn_train_step_matches_reference():
    jcfg, tcfg = JaxMLPConfig(**MLP_KW), MLPConfig(**MLP_KW)
    jp = JD.init_dnn(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu")
    init, update = adamw(1e-2)
    jinit, jupdate = jax_adamw(1e-2)
    step = build_dnn_train_step(tcfg, update, TD.dnn_loss)
    jstep = jax.jit(jax_dnn_step(jcfg, jupdate, JD.dnn_loss))
    opt, jopt = init(params), jinit(jp)
    for b in _mlp_batches():
        params, opt, m = step(params, opt, _t(b))
        jp, jopt, jm = jstep(jp, jopt, _j(b))
        assert set(m) == set(jm) == {"loss", "accuracy", "grad_norm", "lr"}
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-6)
    _leafwise_close(params, jp, 1e-5)


def test_dnn_dropout_draws_from_the_generator():
    cfg = MLPConfig(**MLP_KW, dropout=0.5)
    params = TD.init_dnn(torch.Generator().manual_seed(0), cfg)
    x = _t(_mlp_batches(1)[0])["x"]
    runs = [TD.forward_dnn(params, cfg, x, train=True,
                           key=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    torch.testing.assert_close(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    torch.testing.assert_close(TD.forward_dnn(params, cfg, x),
                               TD.forward_dnn(params, cfg.replace(
                                   dropout=0.0), x))
    _, opt_update = adamw(1e-2)
    init, _ = adamw(1e-2)
    step = build_dnn_train_step(cfg, opt_update, TD.dnn_loss)
    _, _, m = step(params, init(params), _t(_mlp_batches(1)[0]),
                   torch.Generator().manual_seed(1))
    assert np.isfinite(float(m["loss"]))


# ---- the kernels refuse a backward, as the reference's do

@pytest.mark.parametrize("arch", ARCHS)
def test_pallas_backward_is_refused_as_in_the_reference(arch):
    jcfg, tcfg, jp, tp = bridged_model(arch)
    tcfg = tcfg.replace(attention_impl="pallas")
    jcfg = jcfg.replace(attention_impl="pallas")
    batch = _batch(tcfg, seed=6)
    with pytest.raises(NotImplementedError, match="no backward"):
        _port_grads(tp, tcfg, _t(batch))
    with pytest.raises(Exception):
        _jax_grads(jp, jcfg, _j(batch))


@pytest.mark.parametrize("arch", ARCHS)
def test_pallas_forward_without_grad_matches_reference(arch):
    jcfg, tcfg, jp, tp = bridged_model(arch)
    batch = _batch(tcfg, seed=7)
    live = tree_map(lambda p: p.detach().requires_grad_(), tp)
    with torch.no_grad():
        logits, _ = TT.forward_train(
            live, tcfg.replace(attention_impl="pallas"), _t(batch))
    jlogits, _ = JT.forward_train(
        jp, jcfg.replace(attention_impl="pallas"), _j(batch))
    np.testing.assert_allclose(to_np(logits), to_np(jlogits), atol=1e-5,
                               rtol=1e-5)


def test_every_wrapper_refuses_a_gradient_on_the_cpu():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g).requires_grad_()
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    pos = torch.tensor([20], dtype=torch.int32)
    calls = {
        "flash_attention": lambda: flash_attention(r(1, 8, 2, 16),
                                                   r(1, 8, 1, 16),
                                                   r(1, 8, 1, 16)),
        "rglru_scan": lambda: rglru_scan(torch.rand(1, 8, 4,
                                                    generator=g)
                                         .requires_grad_(), r(1, 8, 4)),
        "ssd_scan": lambda: ssd_scan(r(1, 8, 2, 4), torch.rand(
            1, 8, 2, generator=g).requires_grad_(), -torch.rand(2),
            r(1, 8, 1, 4), r(1, 8, 1, 4)),
        "paged_attention": lambda: paged_attention(r(1, 2, 16),
                                                   r(3, 16, 1, 16),
                                                   r(3, 16, 1, 16), table,
                                                   pos),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=name):
            call()
        with torch.no_grad():
            out = call()
        out = out[0] if isinstance(out, tuple) else out
        assert torch.isfinite(out).all() and not out.requires_grad
    # the dense-gather oracle differentiates, as the reference's does
    q = r(1, 2, 16)
    paged_attention(q, r(3, 16, 1, 16), r(3, 16, 1, 16), table, pos,
                    kernel="reference").sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
