"""The Mamba2 decode state step over the paged layout's per-slot state
(`kernels/mamba_state`) on the CPU: its plain version (`ref.py`) against
the dense decode's `ssd_decode_step` on the live rows, a dead row's state
kept bit for bit, which shapes the kernel takes, the refused gradient, and
`mamba2_decode_paged` against the three passes it ran before the step had
a kernel (`_three_passes` below, kept as they were), bit for bit, and the
CUDA route's refusal of a width the kernel does not take.

Layouts (heads, head dim, d_state, groups): granite-4.0-h-small's (128 x
64 x 128, one group) and two grouped ones. Tolerances: the plain step and
`ssd_decode_step` compute the same f32 products, but one adds the update
in place and the other sums a fresh tensor, and the y sums run in other
orders: torch's default f32 tolerances (rtol 1.3e-6, atol 1e-5) hold them.
The card's kernel against the plain version:
tests/test_torch_mamba_state_cuda.py. Imports no JAX.
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import registry
from repro_torch.kernels.mamba_state import ops as MS
from repro_torch.kernels.mamba_state.ref import mamba_state_ref
from repro_torch.models import mamba2 as M2
from repro_torch.models.layers import rms_norm

# name: (heads, head dim, d_state, groups)
LAYOUTS = {"granite-4.0-h-small": (128, 64, 128, 1),
           "grouped": (8, 16, 32, 2),
           "grouped-narrow": (12, 8, 16, 4)}
LIVE = (True, False, True, True, False)


def _inputs(layout, dtype=torch.float32, seed=0, live=LIVE):
    """A state of len(live) rows and one decode token's x, dt, A, B, C."""
    h, p, n, g = LAYOUTS[layout]
    b = len(live)
    gen = torch.Generator().manual_seed(seed)
    ssm = torch.randn((b, h, p, n), generator=gen)
    x = torch.randn((b, h, p), generator=gen).to(dtype)
    dt = F.softplus(torch.randn((b, h), generator=gen) - 2.0)
    A = -torch.exp(torch.randn((h,), generator=gen))
    B = torch.randn((b, g, n), generator=gen).to(dtype)
    C = torch.randn((b, g, n), generator=gen).to(dtype)
    return ssm, x, dt, A, B, C, torch.tensor(live)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ref_equals_the_dense_decode_step_on_live_rows(layout, dtype):
    """On a live row the state and y are `ssd_decode_step`'s (bf16 x, B
    and C widened alike on both sides; y compared before its cast)."""
    ssm, x, dt, A, B, C, live = _inputs(layout, dtype)
    _, want_state = M2.ssd_decode_step(ssm.clone(), x, dt, A, B, C)
    h = x.shape[1]
    rep = h // B.shape[1]
    want_y = torch.einsum("bhpn,bhn->bhp", want_state,
                          C.repeat_interleave(rep, dim=1).float())
    y = mamba_state_ref(ssm, x, dt, A, B, C, live)
    assert y.dtype == torch.float32 and y.shape == x.shape
    torch.testing.assert_close(ssm[live], want_state[live])
    torch.testing.assert_close(y[live], want_y[live])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dead_rows_keep_their_state_bit_for_bit(layout):
    ssm, x, dt, A, B, C, live = _inputs(layout, seed=1)
    before = ssm.clone()
    MS.mamba_state(ssm, x, dt, A, B, C, live)
    assert torch.equal(ssm[~live], before[~live])
    assert not torch.equal(ssm[live], before[live])


@pytest.mark.parametrize("p, n, dtype", [
    (64, 128, torch.float32), (1, 128, torch.float32),
    (32, 32, torch.float32), (256, 32, torch.float32)])
def test_takes_the_f32_state_at_the_widths_of_its_loads(p, n, dtype):
    assert MS.takes(p, n, dtype)


@pytest.mark.parametrize("p, n, dtype", [
    (64, 128, torch.bfloat16), (64, 128, torch.float64),
    (64, 128, torch.float16), (64, 48, torch.float32),
    (64, 512, torch.float32), (64, 8, torch.float32),
    (0, 128, torch.float32), (65, 128, torch.float32),
    (257, 32, torch.float32), (64, 256, torch.float32),
    (64, 16, torch.float32), (64, 64, torch.float32)])
def test_takes_refuses_what_the_kernel_does_not(p, n, dtype):
    assert not MS.takes(p, n, dtype)


@pytest.mark.parametrize("p, n, dtype, refused", [
    (64, 128, torch.float32, False), (32, 32, torch.float32, False),
    (64, 48, torch.float32, True), (64, 256, torch.float32, True),
    (65, 128, torch.float32, True), (257, 32, torch.float32, True),
    (64, 128, torch.bfloat16, True)])
def test_the_kernel_route_refuses_what_takes_refuses(p, n, dtype, refused):
    """The check the CUDA route makes before it launches raises
    ValueError on every state `takes` refuses: on the card such a shape is
    an error, never the plain version."""
    b, h, g = 3, 4, 2
    args = (torch.zeros((b, h, p, n), dtype=dtype), torch.zeros((b, h, p)),
            torch.zeros((b, h)), torch.zeros((h,)), torch.zeros((b, g, n)),
            torch.zeros((b, g, n)), torch.ones(b, dtype=torch.bool))
    assert MS.takes(p, n, dtype) is not refused
    if refused:
        with pytest.raises(ValueError, match="mamba_state"):
            MS._check_cuda_args(*args)
    else:
        MS._check_cuda_args(*args)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    args = _inputs("grouped", seed=2)
    ref_args = [t.clone() for t in args]
    launches = MS.mamba_state.launches
    y = MS.mamba_state(*args)
    want = mamba_state_ref(*ref_args)
    assert torch.equal(y, want) and torch.equal(args[0], ref_args[0])
    assert MS.mamba_state.launches == launches


@pytest.mark.parametrize("grad_of", ["x", "dt", "B"])
def test_a_gradient_is_refused(grad_of):
    ssm, x, dt, A, B, C, live = _inputs("grouped", seed=3)
    named = {"x": x, "dt": dt, "B": B}
    named[grad_of].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="mamba_state"):
        MS.mamba_state(ssm, x, dt, A, B, C, live)
    with torch.no_grad():
        MS.mamba_state(ssm, x, dt, A, B, C, live)


def _three_passes(params, cfg, u, state, live):
    """`mamba2_decode_paged` as it was before the state step had a kernel:
    the decay, the addcmul and the f32 einsum over the whole state."""
    s = cfg.ssm
    B_, _, d = u.shape
    di, nh, g, n = s.d_inner(d), s.n_heads(d), s.n_groups, s.d_state
    gn, rep = g * n, nh // g
    ssm, conv = state["ssm"], state["conv"]
    z, xBC_raw, dt = torch.split(u @ params["in_proj"],
                                 [di, di + 2 * gn, nh], dim=-1)
    conv_buf = torch.cat([conv, xBC_raw], dim=1)
    xBC = F.silu(torch.einsum("bwc,wc->bc", conv_buf, params["conv_w"])
                 + params["conv_b"])
    conv.copy_(torch.where(live[:, None, None], conv_buf[:, 1:], conv))
    x, Bm, Cm = torch.split(xBC, [di, gn, gn], dim=-1)
    x = x.reshape(B_, nh, s.head_dim)
    dtv = F.softplus(dt[:, 0].float() + params["dt_bias"][None, :])
    A = -torch.exp(params["A_log"])
    on = live[:, None]
    decay = torch.where(on, torch.exp(dtv * A[None, :]), 1.0)
    xdt = torch.where(on[..., None], dtv[..., None] * x, 0.0)
    h5 = ssm.view(B_, g, rep, s.head_dim, n)
    ssm.mul_(decay[:, :, None, None])
    h5.addcmul_(xdt.view(B_, g, rep, s.head_dim, 1),
                Bm.float().view(B_, g, 1, 1, n))
    y = torch.einsum("bgrpn,bgn->bgrp", h5, Cm.float().view(B_, g, n))
    y = y.reshape(B_, nh, s.head_dim).to(x.dtype) \
        + x * params["D"][None, :, None]
    y = rms_norm(y.reshape(B_, 1, di) * F.silu(z), params["norm_scale"],
                 cfg.norm_eps)
    return y @ params["out_proj"]


def _layer(impl, dtype, groups):
    base = registry.get("granite-4.0-h-small", reduced=True)
    cfg = base.replace(d_model=128, attention_impl=impl, dtype=dtype,
                       param_dtype=dtype,
                       ssm=dataclasses.replace(base.ssm, n_groups=groups))
    gen = torch.Generator().manual_seed(4)
    params = M2.init_mamba2(gen, cfg)
    params["norm_scale"] = (torch.rand(params["norm_scale"].shape,
                                       generator=gen) - 0.5).to(
        params["norm_scale"].dtype)
    return cfg, params


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2])
def test_paged_decode_is_the_three_passes_bit_for_bit(impl, dtype, groups):
    """Both routes of `mamba2_decode_paged` on the CPU give the output and
    the state (ssm and conv) of the three passes, bit for bit, over three
    steps with dead rows among the live."""
    cfg, params = _layer(impl, dtype, groups)
    s, d = cfg.ssm, cfg.d_model
    nh, cd = s.n_heads(d), M2.conv_dim(cfg)
    live = torch.tensor(LIVE)
    gen = torch.Generator().manual_seed(5)
    state = {"ssm": torch.randn((len(LIVE), nh, s.head_dim, s.d_state),
                                generator=gen),
             "conv": torch.randn((len(LIVE), s.d_conv - 1, cd),
                                 generator=gen).to(cfg.parameter_dtype)}
    old = {k: v.clone() for k, v in state.items()}
    for step in range(3):
        u = torch.randn((len(LIVE), 1, d), generator=gen).to(
            cfg.parameter_dtype)
        got = M2.mamba2_decode_paged(params, cfg, u, state, live)
        want = _three_passes(params, cfg, u, old, live)
        assert torch.equal(got, want), step
        for k in state:
            assert torch.equal(state[k], old[k]), (step, k)


@pytest.mark.parametrize("impl, calls", [("pallas", 1), ("xla", 0)])
def test_the_kernel_switch_picks_the_route(monkeypatch, impl, calls):
    """"pallas" sends the state step to the wrapper (the kernel on CUDA
    tensors it takes), "xla" to the plain version directly."""
    cfg, params = _layer(impl, "float32", 1)
    seen = []
    wrapper = MS.mamba_state

    def counted(*a):
        seen.append(a[0].shape)
        return wrapper(*a)
    monkeypatch.setattr(MS, "mamba_state", counted)
    s, d = cfg.ssm, cfg.d_model
    state = {"ssm": torch.zeros((2, s.n_heads(d), s.head_dim, s.d_state)),
             "conv": torch.zeros((2, s.d_conv - 1, M2.conv_dim(cfg)))}
    M2.mamba2_decode_paged(params, cfg, torch.randn((2, 1, d)), state,
                           torch.tensor([True, False]))
    assert len(seen) == calls
