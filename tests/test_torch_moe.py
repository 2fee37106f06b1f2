"""The port's MoE FFN (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`), float32 on the CPU, with the reference's own
`init_moe` weights: the output and the aux values at capacity factors
8.0 (no drops), 1.25 (granite's) and 0.25 (most entries dropped), with
padded experts, on a tie in the router logits, and the gradients of the
router and the experts; plus the reference's own MoE cases of
tests/test_models.py on the port.

Tolerances: outputs 1e-5, aux 1e-5, each gradient leaf within 1e-4 of
that leaf's largest absolute gradient. The slots a token takes, and so
which entries drop, must be the reference's exactly: the dropped fraction
is compared for equality.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoE  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from _torch_parity import to_np  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

BASE = dict(arch_id="m", family="moe", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=0, vocab_size=53)


def _cfgs(cf=1.25, pad=1, E=4, K=2):
    moe = dict(n_experts=E, top_k=K, expert_d_ff=32, capacity_factor=cf,
               pad_experts_to=pad)
    return (JaxConfig(**BASE, moe=JaxMoE(**moe)),
            ModelConfig(**BASE, moe=MoEConfig(**moe)))


def _weights(jcfg, seed=0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _compare(jcfg, tcfg, jp, tp, x):
    jout, jaux = JM.moe_ffn(jp, jcfg, jnp.asarray(x))
    out, aux = TM.moe_ffn(tp, tcfg, torch.as_tensor(x), want_aux=True)
    np.testing.assert_allclose(to_np(out), to_np(jout), atol=1e-5, rtol=1e-5)
    assert set(aux) == set(jaux)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)
    assert float(aux["dropped_frac"]) == pytest.approx(
        float(jaux["dropped_frac"]), abs=1e-7)
    return aux


@pytest.mark.parametrize("cf,drops", [(8.0, False), (1.25, True),
                                      (0.25, True)])
def test_moe_ffn_matches_reference(cf, drops):
    jcfg, tcfg = _cfgs(cf)
    jp, tp = _weights(jcfg)
    aux = _compare(jcfg, tcfg, jp, tp, _x((3, 16, 64)))
    assert (float(aux["dropped_frac"]) > 0) == drops


def test_padded_experts_are_never_chosen():
    """pad_experts_to=3 pads 4 experts to 6: the buffer is 6 wide, the
    router 4, and the result is the reference's."""
    jcfg, tcfg = _cfgs(1.25, pad=3)
    assert tcfg.moe.padded_n_experts == 6
    jp, tp = _weights(jcfg)
    assert tuple(tp["router"].shape) == (64, 4)
    assert tuple(tp["w_gate"].shape) == (6, 64, 32)
    _compare(jcfg, tcfg, jp, tp, _x((2, 12, 64)))
    # killing the padded experts' weights changes nothing
    dead = dict(tp, **{k: tp[k].clone() for k in ("w_gate", "w_up",
                                                  "w_down")})
    for k in ("w_gate", "w_up", "w_down"):
        dead[k][4:] = float("nan")
    x = torch.as_tensor(_x((2, 12, 64)))
    out, _ = TM.moe_ffn(tp, tcfg, x)
    out_dead, _ = TM.moe_ffn(dead, tcfg, x)
    assert torch.equal(out, out_dead)


def test_ties_go_to_the_lower_expert_as_in_lax_top_k():
    """All-zero tokens give all-equal router logits: `lax.top_k` takes
    experts 0..K-1, so must the port (`torch.topk` does not promise it)."""
    jcfg, tcfg = _cfgs(8.0, E=8, K=3)
    jp, tp = _weights(jcfg)
    logits = torch.tensor([[0.0] * 8, [1.0, 2.0, 2.0, 0.0, 2.0, 2.0, 1.0,
                                       1.0]])
    _, idx = TM.route(logits, 3)
    jidx = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)[1]
    assert idx.tolist() == np.asarray(jidx).tolist() == [[0, 1, 2],
                                                         [1, 2, 4]]
    x = _x((2, 6, 64))
    x[:, ::2] = 0.0           # ties in every other token's logits
    _compare(jcfg, tcfg, jp, tp, x)


def test_gradients_match_reference():
    """d(sum(out * w) + lb + z)/d(x, router, experts) at capacity 1.25
    (some entries dropped)."""
    jcfg, tcfg = _cfgs(1.25)
    jp, tp = _weights(jcfg)
    x = _x((2, 16, 64))
    w = _x((2, 16, 64), seed=2)

    def jloss(p, xx):
        out, aux = JM.moe_ffn(p, jcfg, xx)
        return jnp.sum(out * w) + aux["load_balance"] + aux["router_z"]
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    live = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.as_tensor(x).requires_grad_()
    out, aux = TM.moe_ffn(live, tcfg, xt, want_aux=True)
    loss = (out * torch.as_tensor(w)).sum() + aux["load_balance"] \
        + aux["router_z"]
    grads = torch.autograd.grad(loss, [xt] + [live[k] for k in live])
    want = [jgx] + [jgp[k] for k in live]
    for name, g, j in zip(["x"] + list(live), grads, want):
        j = np.asarray(j)
        scale = float(np.abs(j).max())
        assert scale > 0, name
        assert float(np.abs(to_np(g) - j).max()) <= 1e-4 * scale, name


def test_capacity_is_the_reference_line():
    """C = int(max(K, round(S * K * cf / E))): Python's round, half to
    even, on the group's length, pads included."""
    _, tcfg = _cfgs(1.25)
    got = [TM.capacity(tcfg, S) for S in (1, 2, 3, 4, 5, 8, 12, 16)]
    assert got == [int(max(2, round(S * 2 * 1.25 / 4)))
                   for S in (1, 2, 3, 4, 5, 8, 12, 16)]
    assert TM.capacity(tcfg, 4) == 2 and TM.capacity(tcfg, 12) == 8


def test_aux_only_when_asked():
    _, tcfg = _cfgs(1.25)
    tp = TM.init_moe(torch.Generator().manual_seed(0), tcfg)
    x = torch.as_tensor(_x((2, 8, 64)))
    out, aux = TM.moe_ffn(tp, tcfg, x)
    out2, aux2 = TM.moe_ffn(tp, tcfg, x, want_aux=True)
    assert aux is None and set(aux2) == {"load_balance", "router_z",
                                         "dropped_frac"}
    assert torch.equal(out, out2)


# ---- the reference's MoE cases of tests/test_models.py, on the port

def test_moe_top_k_routing_uses_k_experts():
    _, tcfg = _cfgs(8.0)
    params = TM.init_moe(torch.Generator().manual_seed(0), tcfg)
    x = torch.randn((2, 8, 64), generator=torch.Generator().manual_seed(1))
    out, aux = TM.moe_ffn(params, tcfg, x, want_aux=True)
    assert out.shape == x.shape
    assert float(aux["dropped_frac"]) < 1e-6      # capacity_factor=8 -> no drops
    assert float(aux["load_balance"]) >= 1.0 - 1e-3  # >= 1 by Cauchy-Schwarz


def test_moe_capacity_drops_tokens():
    _, tcfg = _cfgs(0.25)
    params = TM.init_moe(torch.Generator().manual_seed(0), tcfg)
    x = torch.randn((2, 16, 64), generator=torch.Generator().manual_seed(1))
    _, aux = TM.moe_ffn(params, tcfg, x, want_aux=True)
    assert float(aux["dropped_frac"]) > 0.0
