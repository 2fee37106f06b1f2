"""The Mamba2 decode state step kernel (csrc/mamba_state.cu) against its
plain version (`kernels/mamba_state/ref.py`) on the card.

Cases (heads, head dim, d_state, groups, slots): docqa's decode step
(granite-4.0-h-small's 128 heads of 64 x 128, one group, 64 slots, half
of them dead) with x, B and C read in bf16 and in f32 as views of one
(slots, conv_dim) tensor, laid out slot-minor as the served decode's conv
einsum gives it, and row-major; a grouped layout; the reduced configs'
d_state 32, also at its most rows a head (256); and head dim 40 (a block
with rows to spare, no multiple of a thread's 8). The kernel's h' and y
must match the plain version's in f32 on the live rows, a dead row's
state must keep its bits and its y read zero, and two calls must give the
same bits (no atomics). A width the kernel does not take raises.
Then the same inside a captured CUDA graph replayed twice, and the
launch count of granite-4.0-h-small's fused decode graph at full depth:
one launch per Mamba2 layer (36) per decode step.

Tolerances, against the plain version run on the card (TF32 off):

* h': 1e-6 of the largest |h'|. Both sides take the same f32 products
  (the kernel fuses (dt x) B into the add, as PyTorch's CUDA addcmul may):
  an element lies at most a rounding or two apart.
* y: 1e-5 of the row's sum of |C h'|. An f32 sum of 128 or 256 terms in
  another order than the einsum's moves by at most a few units of 2^-24
  times that sum.

Skips where torch sees no CUDA device. Imports no JAX. Run on the card
with ``PYTHONPATH=src python -m pytest -q tests/test_torch_mamba_state_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs import registry
from repro_torch.kernels.mamba_state import ops as MS
from repro_torch.kernels.mamba_state.ref import mamba_state_ref
from repro_torch.models import transformer as T
from repro_torch.serve.graph import FusedDecodeGraph
from repro_torch.serve.step import build_decode_fused

pytestmark = pytest.mark.gpu

H_TOL, Y_TOL = 1e-6, 1e-5
# name: (heads, head dim, d_state, groups, slots, dtype of x, B and C,
# the conv output slot-minor)
CASES = {
    "docqa_bf16": (128, 64, 128, 1, 64, torch.bfloat16, True),
    "docqa_bf16_row_major": (128, 64, 128, 1, 64, torch.bfloat16, False),
    "docqa_f32": (128, 64, 128, 1, 64, torch.float32, True),
    "grouped": (24, 32, 128, 4, 16, torch.bfloat16, False),
    "d_state_32": (8, 32, 32, 2, 8, torch.float32, True),
    "d_state_32_most_rows": (4, 256, 32, 2, 8, torch.bfloat16, False),
    "ragged_rows": (6, 40, 128, 3, 8, torch.float32, True),
}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_case(name, device, seed=0):
    """The state, dt, A, a live mask with every other slot dead, and x, B,
    C as views of one (slots, conv_dim) tensor in the case's dtype."""
    h, p, n, g, b, dtype, slot_minor = CASES[name]
    gen = torch.Generator(device=device).manual_seed(seed)
    di, gn = h * p, g * n
    xBC = torch.randn((di + 2 * gn, b), generator=gen, device=device).t() \
        if slot_minor else torch.randn((b, di + 2 * gn), generator=gen,
                                       device=device)
    xBC = xBC.to(dtype, memory_format=torch.preserve_format)
    x = xBC[:, :di].reshape(b, h, p)
    B = xBC[:, di:di + gn].view(b, g, n)
    C = xBC[:, di + gn:].view(b, g, n)
    ssm = torch.randn((b, h, p, n), generator=gen, device=device)
    dt = F.softplus(torch.randn((b, h), generator=gen, device=device) - 2.0)
    A = -torch.exp(torch.randn((h,), generator=gen, device=device))
    live = torch.arange(b, device=device) % 2 == 0
    return ssm, x, dt, A, B, C, live


def check(got_ssm, got_y, want_ssm, want_y, before, live, C):
    """The kernel's state and y against the plain version's (live rows),
    the dead rows' state and y."""
    h = got_ssm.shape[1]
    Ch = C.float().repeat_interleave(h // C.shape[1], dim=1)
    scale = torch.einsum("bhpn,bhn->bhp", want_ssm.abs(), Ch.abs())
    h_err = float((got_ssm[live] - want_ssm[live]).abs().max()
                  / want_ssm[live].abs().max())
    y_err = float(((got_y[live] - want_y[live]).abs()
                   / scale[live]).max())
    assert h_err <= H_TOL, h_err
    assert y_err <= Y_TOL, y_err
    assert torch.equal(got_ssm[~live], before[~live])
    assert torch.equal(got_y[~live], torch.zeros_like(got_y[~live]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_the_plain_version(name, device):
    ssm, x, dt, A, B, C, live = make_case(name, device)
    h, p, n = ssm.shape[1:]
    assert MS.takes(p, n, ssm.dtype)
    before = ssm.clone()
    want_ssm = ssm.clone()
    want_y = mamba_state_ref(want_ssm, x, dt, A, B, C, live)
    launches = MS.mamba_state.launches
    got_y = MS.mamba_state(ssm, x, dt, A, B, C, live)
    torch.cuda.synchronize()
    assert MS.mamba_state.launches == launches + 1
    check(ssm, got_y, want_ssm, want_y, before, live, C)
    again = before.clone()
    again_y = MS.mamba_state(again, x, dt, A, B, C, live)
    assert torch.equal(again, ssm) and torch.equal(again_y, got_y)


@pytest.mark.parametrize("p, n, dtype", [
    (8, 48, torch.float32), (8, 256, torch.float32), (8, 16, torch.float32),
    (65, 128, torch.float32), (257, 32, torch.float32),
    (8, 128, torch.bfloat16)])
def test_a_shape_it_does_not_take_is_refused(p, n, dtype, device):
    """A d_state other than 128 or 32, more rows a head than one block
    covers, or a state that is not f32: the wrapper raises ValueError on
    the card, launches nothing, counts nothing and leaves the state as it
    was (the plain version runs on CPU tensors only)."""
    gen = torch.Generator(device=device).manual_seed(1)
    b, h = 4, 4
    ssm = torch.randn((b, h, p, n), generator=gen, device=device).to(dtype)
    args = (torch.randn((b, h, p), generator=gen, device=device),
            torch.rand((b, h), generator=gen, device=device),
            -torch.rand((h,), generator=gen, device=device),
            torch.randn((b, 1, n), generator=gen, device=device),
            torch.randn((b, 1, n), generator=gen, device=device),
            torch.tensor([True, False, True, True], device=device))
    before = ssm.clone()
    launches = MS.mamba_state.launches
    with pytest.raises(ValueError, match="mamba_state"):
        MS.mamba_state(ssm, *args)
    torch.cuda.synchronize()
    assert MS.mamba_state.launches == launches
    assert torch.equal(ssm, before)


def test_kernel_in_a_captured_graph_replayed_twice(device):
    """docqa's shape captured once, replayed twice: each replay steps the
    live rows again, as two plain steps do; the dead rows stay."""
    ssm, x, dt, A, B, C, live = make_case("docqa_bf16", device, seed=2)
    before = ssm.clone()
    want_ssm = ssm.clone()
    mamba_state_ref(want_ssm, x, dt, A, B, C, live)
    want_y = mamba_state_ref(want_ssm, x, dt, A, B, C, live)
    # warm on a copy, so that the state steps only in the replays
    MS.mamba_state(ssm.clone(), x, dt, A, B, C, live)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    captured = kernels.captured_here()
    launches = MS.mamba_state.launches
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            y = MS.mamba_state(ssm, x, dt, A, B, C, live)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    assert kernels.captured_since(captured) == {MS.mamba_state: 1}
    assert MS.mamba_state.launches == launches
    assert torch.equal(ssm, before)           # the capture ran nothing
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    check(ssm, y, want_ssm, want_y, before, live, C)


def test_fused_graph_launches_once_per_mamba_layer_per_step(device):
    """granite-4.0-h-small at full depth and widths (36 Mamba2 and 4
    attention layers; 4 of the 72 experts held, which the count does not
    read), one fused dispatch of N steps over 4 slots, two of them live:
    36 launches a decode step, in the replay and in each eager warm-up run
    of the body, and a dead slot's state keeps its bits."""
    full = registry.get("granite-4.0-h-small")
    cfg = full.replace(dtype="bfloat16", param_dtype="bfloat16",
                       attention_impl="pallas",
                       moe=dataclasses.replace(full.moe, held_experts=4))
    n_mamba = cfg.layer_types().count("ssm")
    assert n_mamba == 36
    slots, bs, nb, N = 4, 16, 8, 8
    params = T.init_lm(torch.Generator(device=device).manual_seed(0), cfg)
    cache = T.init_paged_cache(cfg, slots * nb + 1, bs, device, slots)
    gen = torch.Generator(device=device).manual_seed(3)
    ssms = [c["ssm"] for c in cache if "ssm" in c]
    for t in ssms:
        t.copy_(torch.randn(t.shape, generator=gen, device=device) * 0.1)
    kept = [t[1].clone() for t in ssms]
    table = np.zeros((slots, nb), np.int32)
    for s in (0, 2):
        table[s] = np.arange(1 + s * nb, 1 + (s + 1) * nb)
    live = torch.tensor([True, False, True, False], device=device)
    ints = {"tokens": np.full((slots, 1), 7), "pos": np.full(slots, 3),
            "eos": np.full(slots, -1), "steps": np.full(slots, N)}
    args = {k: torch.as_tensor(v.astype(np.int32), device=device)
            for k, v in ints.items()}
    fused = FusedDecodeGraph(build_decode_fused(cfg, N))
    launches = MS.mamba_state.launches
    emitted, _, _, _ = fused(params, args["tokens"], args["pos"], cache,
                             torch.tensor(table, device=device), args["eos"],
                             live, args["steps"])
    torch.cuda.synchronize()
    assert fused.replays == 1 and fused.captures == 1
    assert MS.mamba_state.launches - launches == \
        n_mamba * N * (fused.replays + fused.warmup_runs)
    assert emitted[:, [0, 2]].min() >= 0
    assert all(torch.equal(t[1], k) for t, k in zip(ssms, kept))
