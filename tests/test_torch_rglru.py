"""repro_torch.models.rglru against repro.models.rglru, float32 on the
CPU, on reduced recurrentgemma-9b (lru width 256) with the reference's own
weights bridged over. Inputs are numpy draws from a seed handed to both.

Tolerance 1e-5: a few f32 roundings apart (the log-depth scan and the
sequential plain version sum in another order than XLA's associative
scan).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import rglru as JR  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from _torch_parity import bridged_model, to_np  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    return bridged_model("recurrentgemma-9b")


def _block(model, impl):
    """(jax cfg, torch cfg, jax rglru params, torch rglru params) of the
    first layer, with attention_impl set on both configs."""
    jcfg, tcfg, jp, tp = model
    jparams = jax.tree.map(lambda a: a[0], jp["blocks"][0]["rglru"])
    return (jcfg.replace(attention_impl=impl),
            tcfg.replace(attention_impl=impl), jparams,
            tp["layers"][0]["rglru"])


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(to_np(t), to_np(j), atol=TOL, rtol=TOL)


def test_gates(model):
    jcfg, tcfg, jp, tp = _block(model, "xla")
    x = _rand(np.random.default_rng(0), 2, 7, 256)
    ja, jg = jax.jit(JR._gates, static_argnums=1)(jp, jcfg, jnp.asarray(x))
    ta, tg = TR._gates(tp, tcfg, torch.as_tensor(x))
    _close(ta, ja)
    _close(tg, jg)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_rglru_scan(model, impl, with_h0):
    """With an initial state both configs take the plain scan, as in the
    reference; without one, "pallas" takes the kernel's port."""
    jcfg, tcfg, jp, tp = _block(model, impl)
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 19, 256)
    h0 = _rand(rng, 2, 256) if with_h0 else None
    jy, jh = jax.jit(JR.rglru_scan, static_argnums=1)(
        jp, jcfg, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    ty, th = TR.rglru_scan(tp, tcfg, torch.as_tensor(x),
                           None if h0 is None else torch.as_tensor(h0))
    assert th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_block_forward_then_decode(model, impl):
    """The full-sequence block, then decode steps continuing from its
    cache, through both stacks."""
    jcfg, tcfg, jp, tp = _block(model, impl)
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 11, 256)
    jout, jcache = jax.jit(JR.rglru_block_forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(x))
    tout, tcache = TR.rglru_block_forward(tp, tcfg, torch.as_tensor(x))
    _close(tout, jout)
    for k in ("h", "conv"):
        _close(tcache[k], jcache[k])
    jdec = jax.jit(JR.rglru_block_decode, static_argnums=1)
    for _ in range(3):
        xt = _rand(rng, 2, 1, 256)
        jout, jcache = jdec(jp, jcfg, jnp.asarray(xt), jcache)
        before = {k: v.clone() for k, v in tcache.items()}
        tout, new = TR.rglru_block_decode(tp, tcfg, torch.as_tensor(xt),
                                          tcache)
        # the decode step is functional: its input cache is unchanged
        assert all(torch.equal(tcache[k], before[k]) for k in before)
        tcache = new
        _close(tout, jout)
        for k in ("h", "conv"):
            _close(tcache[k], jcache[k])


def test_short_sequence_conv_history_is_zero_filled(model):
    """A sequence shorter than the conv window (the reference returns
    fewer rows there) gives a full-width history, zero on the left, so the
    decode step can take it."""
    _, tcfg, _, tp = _block(model, "xla")
    x = torch.as_tensor(_rand(np.random.default_rng(3), 1, 2, 256))
    _, cache = TR.rglru_block_forward(tp, tcfg, x)
    assert tuple(cache["conv"].shape) == (1, tcfg.rglru.d_conv - 1, 256)
    assert torch.equal(cache["conv"][:, 0], torch.zeros_like(
        cache["conv"][:, 0]))
    np.testing.assert_array_equal(cache["conv"][:, 1:].numpy(),
                                  (x @ tp["w_x"]).numpy())
