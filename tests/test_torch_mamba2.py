"""repro_torch.models.mamba2 against repro.models.mamba2, float32 on the
CPU, on reduced mamba2-130m (d_model 256, 16 heads of head_dim 32, d_state
32, chunk 16) with the reference's own weights bridged over. Inputs are
numpy draws from a seed handed to both.

Tolerance 1e-4: a few f32 roundings apart (the port's plain SSD version is
the sequential recurrence, the reference's routes chunked sums).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import mamba2 as JM  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from _torch_parity import bridged_model, to_np  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

TOL = 1e-4
D = 256


@pytest.fixture(scope="module")
def model():
    return bridged_model("mamba2-130m")


def _block(model, impl):
    """(jax cfg, torch cfg, jax mamba params, torch mamba params) of the
    first layer, with attention_impl set on both configs."""
    jcfg, tcfg, jp, tp = model
    jparams = jax.tree.map(lambda a: a[0], jp["blocks"][0]["mamba"])
    return (jcfg.replace(attention_impl=impl),
            tcfg.replace(attention_impl=impl), jparams,
            tp["layers"][0]["mamba"])


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(to_np(t), to_np(j), atol=tol, rtol=tol)


def _caches_close(tcache, jcache):
    assert set(tcache) == set(jcache) == {"ssm", "conv"}
    assert tcache["ssm"].dtype == torch.float32
    for k in tcache:
        _close(tcache[k], jcache[k])


def test_causal_conv(model):
    _, tcfg, jp, tp = _block(model, "xla")
    xBC = _rand(np.random.default_rng(0), 2, 11, TM.conv_dim(tcfg))
    jout = jax.jit(JM._causal_conv)(jnp.asarray(xBC), jp["conv_w"],
                                    jp["conv_b"])
    tout = TM._causal_conv(torch.as_tensor(xBC), tp["conv_w"], tp["conv_b"])
    _close(tout, jout)


def test_ssd_decode_step():
    rng = np.random.default_rng(1)
    b, h, p, g, n = 2, 4, 8, 2, 16
    state = _rand(rng, b, h, p, n)
    x = _rand(rng, b, h, p)
    dt = np.abs(_rand(rng, b, h)) * 0.1
    A = -np.exp(_rand(rng, h) * 0.5)
    B, C = _rand(rng, b, g, n), _rand(rng, b, g, n)
    jy, jst = jax.jit(JM.ssd_decode_step)(
        *(jnp.asarray(a) for a in (state, x, dt, A, B, C)))
    ty, tst = TM.ssd_decode_step(
        *(torch.as_tensor(a) for a in (state, x, dt, A, B, C)))
    _close(ty, jy)
    _close(tst, jst)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_then_decode(model, impl):
    """The full-sequence block (32 tokens, two chunks: the reference's
    Pallas route takes it), then decode steps continuing from its cache,
    through both stacks."""
    jcfg, tcfg, jp, tp = _block(model, impl)
    rng = np.random.default_rng(2)
    u = _rand(rng, 2, 32, D)
    jout, jcache = jax.jit(JM.mamba2_forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(u))
    tout, tcache = TM.mamba2_forward(tp, tcfg, torch.as_tensor(u))
    _close(tout, jout)
    _caches_close(tcache, jcache)
    jdec = jax.jit(JM.mamba2_decode, static_argnums=1)
    for _ in range(3):
        ut = _rand(rng, 2, 1, D)
        jout, jcache = jdec(jp, jcfg, jnp.asarray(ut), jcache)
        before = {k: v.clone() for k, v in tcache.items()}
        tout, new = TM.mamba2_decode(tp, tcfg, torch.as_tensor(ut), tcache)
        # the decode step is functional: its input cache is unchanged
        assert all(torch.equal(tcache[k], before[k]) for k in before)
        tcache = new
        _close(tout, jout)
        _caches_close(tcache, jcache)


@pytest.mark.parametrize("S", [20, 37])
def test_ragged_forward_on_the_kernel_route(model, S):
    """A sequence that is not a multiple of the chunk (16): the
    reference's Pallas route asserts on it (ROADMAP.md Queue 3); the
    port's "pallas" route serves it and matches the reference's "xla"
    route."""
    jcfg, _, jp, _ = _block(model, "xla")
    _, tcfg, _, tp = _block(model, "pallas")
    u = _rand(np.random.default_rng(3), 1, S, D)
    with pytest.raises(AssertionError):
        JM.mamba2_forward(jp, jcfg.replace(attention_impl="pallas"),
                          jnp.asarray(u))
    jout, jcache = jax.jit(JM.mamba2_forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(u))
    tout, tcache = TM.mamba2_forward(tp, tcfg, torch.as_tensor(u))
    _close(tout, jout)
    _caches_close(tcache, jcache)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("S", [1, 2, 3])
def test_short_prompt_matches_decode_mode(model, impl, S):
    """A prompt shorter than the conv window (d_conv - 1 = 3): the bulk
    forward's cache is zero-filled on the left, so decoding on from it
    gives what feeding the prompt token by token from an empty cache
    gives, in the port and in the reference's decode step. The
    reference's own bulk cache has only S rows there (ROADMAP.md Queue 3),
    so it is not the yardstick."""
    jcfg, tcfg, jp, tp = _block(model, impl)
    hist = tcfg.ssm.d_conv - 1
    rng = np.random.default_rng(4 + S)
    u = _rand(rng, 2, S + 3, D)
    prompt, rest = u[:, :S], u[:, S:]
    _, jbulk = jax.jit(JM.mamba2_forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(prompt))
    assert jbulk["conv"].shape[1] == min(S, hist)
    tout, tcache = TM.mamba2_forward(tp, tcfg, torch.as_tensor(prompt))
    assert tuple(tcache["conv"].shape) == (2, hist, TM.conv_dim(tcfg))
    # decode mode: every token through the decode step from an empty cache
    jdec = jax.jit(JM.mamba2_decode, static_argnums=1)
    s = tcfg.ssm
    jcache = {"ssm": jnp.zeros((2, s.n_heads(D), s.head_dim, s.d_state),
                               jnp.float32),
              "conv": jnp.zeros((2, hist, TM.conv_dim(tcfg)), jnp.float32)}
    dcache = {k: torch.zeros(tuple(v.shape)) for k, v in jcache.items()}
    for t in range(S):
        jout, jcache = jdec(jp, jcfg, jnp.asarray(prompt[:, t:t + 1]), jcache)
        dout, dcache = TM.mamba2_decode(tp, tcfg,
                                        torch.as_tensor(prompt[:, t:t + 1]),
                                        dcache)
        _close(dout, jout)
    _close(tout[:, -1:], jout)
    _caches_close(tcache, jcache)
    _caches_close(dcache, jcache)
    for t in range(rest.shape[1]):
        ut = rest[:, t:t + 1]
        jout, jcache = jdec(jp, jcfg, jnp.asarray(ut), jcache)
        tout, tcache = TM.mamba2_decode(tp, tcfg, torch.as_tensor(ut), tcache)
        _close(tout, jout)
    _caches_close(tcache, jcache)
