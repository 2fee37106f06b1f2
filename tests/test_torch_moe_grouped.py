"""The MoE FFN's grouped experts (`models/moe.py::_grouped`, the plain
version `kernels/moe_experts/ref.py` on the CPU) against the GShard buffer
path (`_experts`), float32: where no entry of a dispatch group can be
dropped (C >= S) the two compute the same function, so the grouped path
must equal the buffer path to f32 rounding (rel 1e-5) at a decode step of
64 rows, a speculative verification of k+1 tokens, a short prompt, with
held experts (first 0 and past 0), a shared expert and padded experts, and
give the same aux values with a dropped fraction of exactly 0. The path
follows the group's shape: C >= S takes the grouped experts, C < S the
buffer path, which still drops; a gradient keeps the buffer path (the
kernel has no backward).

The buffer path is reached on a C >= S shape by switching the selection
off (`moe.grouped`), nothing else.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels.moe_experts import ops as ME
from repro_torch.kernels.moe_experts.ref import moe_dispatch_ref
from repro_torch.models import moe as TM
from _torch_parity import one_torch_thread  # noqa: F401

D, FF = 128, 64          # the narrowest widths the kernel takes
BASE = dict(arch_id="m", family="moe", n_layers=2, d_model=D, n_heads=4,
            n_kv_heads=2, d_ff=0, vocab_size=53)


def _cfg(E=8, K=4, ff=FF, base=(), **moe):
    return ModelConfig(**{**BASE, **dict(base)}, moe=MoEConfig(
        n_experts=E, top_k=K, expert_d_ff=ff, **moe))


def _params(cfg, seed=0):
    return TM.init_moe(torch.Generator().manual_seed(seed), cfg)


def _x(B, S, seed=1, d=D):
    return torch.randn((B, S, d), generator=torch.Generator().manual_seed(
        seed))


def _buffer(params, cfg, x, monkeypatch, **kw):
    with monkeypatch.context() as mp:
        mp.setattr(TM, "grouped", lambda *a, **k: False)
        return TM.moe_ffn(params, cfg, x, **kw)


class Calls:
    """Counts the grouped wrappers' calls, passing them through."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("moe_dispatch", "moe_experts"):
            fn = getattr(ME, name)
            monkeypatch.setattr(ME, name, self._wrap(fn))

    def _wrap(self, fn):
        def counted(*a, **k):
            self.n += 1
            return fn(*a, **k)
        return counted


CASES = {
    # name: (moe config, B, S)
    "decode_b64": (dict(), 64, 1),
    "spec_k3": (dict(), 8, 4),              # k+1 = 4 <= C = 4
    "short_prompt": (dict(E=4, K=2), 3, 2),  # S = 2 <= C = 2
    "held_first0": (dict(held_experts=4), 64, 1),
    "held_first3": (dict(held_experts=4, first_held=3), 16, 2),
    "shared_expert": (dict(shared_d_ff=48), 32, 1),
    "padded_experts": (dict(E=4, K=2, pad_experts_to=3), 16, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_equals_the_buffer_path(case, monkeypatch):
    moe, B, S = CASES[case]
    cfg = _cfg(**moe)
    assert TM.grouped(cfg, S) and TM.capacity(cfg, S) >= S
    params = _params(cfg)
    x = _x(B, S)
    calls = Calls(monkeypatch)
    out, aux = TM.moe_ffn(params, cfg, x, want_aux=True)
    assert calls.n == 2
    want, want_aux = _buffer(params, cfg, x, monkeypatch, want_aux=True)
    assert calls.n == 2
    scale = float(want.abs().max())
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * scale)
    assert set(aux) == set(want_aux)
    for k in ("load_balance", "router_z"):
        assert float(aux[k]) == pytest.approx(float(want_aux[k]), rel=1e-5)
    assert float(aux["dropped_frac"]) == 0.0 == float(
        want_aux["dropped_frac"])
    out2, aux2 = TM.moe_ffn(params, cfg, x)
    assert aux2 is None and torch.equal(out, out2)


def test_unheld_and_padded_experts_add_nothing():
    """An entry routed to an expert not held adds zeros; NaN in a padded
    expert's weights (never chosen) moves nothing."""
    cfg = _cfg(E=4, K=2, pad_experts_to=3)
    params = _params(cfg)
    dead = dict(params, **{k: params[k].clone() for k in ("w_gate", "w_up",
                                                          "w_down")})
    for k in ("w_gate", "w_up", "w_down"):
        dead[k][4:] = float("nan")
    x = _x(16, 1)
    assert torch.equal(TM.moe_ffn(params, cfg, x)[0],
                       TM.moe_ffn(dead, cfg, x)[0])
    held = _cfg(held_experts=4, first_held=2)
    p = _params(held)
    flat = torch.tensor([0, 2, 7, 5, 1, 3, 4, 6])
    perm, off = moe_dispatch_ref(flat, 2, 4)
    y = ME.moe_experts(torch.randn(2, D), perm, off, p["w_gate"],
                       p["w_up"], p["w_down"], top_k=4, act="silu")
    unheld = [0, 2, 4, 7]                   # experts 0, 7, 1, 6
    assert torch.equal(y[unheld], torch.zeros(4, D))
    assert bool((y[[1, 3, 5, 6]].abs().sum(-1) > 0).all())


def test_the_path_follows_the_shape(monkeypatch):
    """C >= S: the grouped experts; C < S: the buffer path, which drops."""
    cfg = _cfg(E=4, K=2, capacity_factor=0.25)
    params = _params(cfg)
    assert [TM.grouped(cfg, S) for S in (1, 2, 3, 16)] == \
        [True, True, False, False]
    calls = Calls(monkeypatch)
    TM.moe_ffn(params, cfg, _x(4, 2))
    assert calls.n == 2
    _, aux = TM.moe_ffn(params, cfg, _x(2, 16), want_aux=True)
    assert calls.n == 2
    assert float(aux["dropped_frac"]) > 0.0
    assert not TM.grouped(cfg, 1, tp=object())


@pytest.mark.parametrize("case", ["d_64", "ff_32", "held_257", "gelu"])
def test_the_path_follows_the_kernels_limits(case, monkeypatch):
    """Experts the kernel does not take keep the buffer path at C >= S,
    on the CPU as on the card: widths off its tiles, more experts than its
    dispatch holds, an activation other than SiLU (and a dtype other than
    f32 and bf16, which no config of the port can name)."""
    cfg = {"d_64": lambda: _cfg(base={"d_model": 64}),
           "ff_32": lambda: _cfg(ff=32),
           "held_257": lambda: _cfg(E=257, K=1, ff=FF),
           "gelu": lambda: _cfg(base={"act": "gelu"})}[case]()
    assert TM.capacity(cfg, 1) >= 1 and not TM.grouped(cfg, 1)
    m = cfg.moe
    assert not ME.takes(cfg.d_model, m.expert_d_ff, m.n_held,
                        cfg.activation_dtype, cfg.act)
    if case != "held_257":
        calls = Calls(monkeypatch)
        out, aux = TM.moe_ffn(_params(cfg), cfg, _x(8, 1, d=cfg.d_model),
                              want_aux=True)
        assert calls.n == 0 and bool(torch.isfinite(out).all())
    assert ME.takes(D, FF, 256, torch.bfloat16, "silu")
    assert not ME.takes(D, FF, 8, torch.float16, "silu")


def test_a_gradient_keeps_the_buffer_path(monkeypatch):
    cfg = _cfg()
    params = {k: v.clone().requires_grad_() for k, v in
              _params(cfg).items()}
    x = _x(8, 1)
    calls = Calls(monkeypatch)
    out, _ = TM.moe_ffn(params, cfg, x)
    out.sum().backward()
    assert calls.n == 0 and params["w_gate"].grad is not None
    with torch.no_grad():
        out_ng, _ = TM.moe_ffn(params, cfg, x)
    assert calls.n == 2
    torch.testing.assert_close(out_ng, out.detach(), rtol=1e-5, atol=1e-6)


def test_dispatch_orders_the_entries_by_expert_stably():
    g = torch.Generator().manual_seed(3)
    flat = torch.randint(0, 12, (200,), generator=g)
    perm, off = moe_dispatch_ref(flat, 3, 6)
    assert perm.dtype == off.dtype == torch.int32
    assert tuple(off.shape) == (8,) and int(off[-1]) == 200
    assert sorted(perm.tolist()) == list(range(200))
    for e in range(6):
        rows = perm[off[e]:off[e + 1]].tolist()
        assert rows == [i for i in range(200) if int(flat[i]) == 3 + e]
    rest = perm[off[6]:].tolist()
    assert rest == [i for i in range(200) if not 3 <= int(flat[i]) < 9]


def test_cpu_calls_count_no_launches_and_refuse_a_gradient():
    cfg = _cfg()
    p = _params(cfg)
    perm, off = moe_dispatch_ref(torch.tensor([1, 0, 5, 2]), 0, 8)
    before = ME.moe_experts.launches
    ME.moe_experts(torch.randn(1, D), perm, off, p["w_gate"], p["w_up"],
                   p["w_down"], top_k=4, act="silu")
    assert ME.moe_experts.launches == before
    with pytest.raises(NotImplementedError):
        ME.moe_experts(torch.randn(1, D, requires_grad=True), perm, off,
                       p["w_gate"], p["w_up"], p["w_down"], top_k=4,
                       act="silu")
