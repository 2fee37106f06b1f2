"""The grouped MoE experts kernel (csrc/moe_experts.cu) against its plain
version (`kernels/moe_experts/ref.py`) on the card.

Cases: granite-moe-3b-a800m's decode step (64 rows, 40 experts top-8, d
1,536, ff 512) and granite-4.0-h-small's (64 rows, experts 0-35 of 72
held, top-10, d 4,096, ff 768) in bf16, and a reduced shape (16 rows, 8
experts top-2 with 6 held from expert 1, d 256, ff 128) in f32 with TF32
off. The dispatch's order must be the plain version's exactly (a stable
sort), the rows of entries whose expert is not held exact zeros, and two
calls bitwise equal (no atomics in any sum).

Tolerances, on the widest row's relative error |y - plain| / |plain| over
the entries of held experts:

* bf16: 2e-2. Both sides round g = x Wg, u = x Wu, act(g) and h to bf16
  after f32 sums, but sum in other orders, so a rounding of g, u or h may
  land one bf16 step (2^-8 relative) apart on a few elements of a row:
  well under 1% of the row.
* f32: 1e-5. f32 sums in another order over at most 256 terms, far under
  that.

Two planted faults of the plain version must read above the tolerance:
one entry's row gathered from its neighbouring token's, and one expert's
weights read from the next expert's. Skips where torch sees no
CUDA device. Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_moe_experts_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels.moe_experts import ops as ME
from repro_torch.kernels.moe_experts.ref import (moe_dispatch_ref,
                                                 moe_experts_ref)
from repro_torch.models.layers import ACTIVATIONS

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# name: (rows, experts routed, top_k, held, first held, d, ff, dtype)
CASES = {
    "longgen_decode": (64, 40, 8, 40, 0, 1536, 512, torch.bfloat16),
    "docqa_decode": (64, 72, 10, 36, 0, 4096, 768, torch.bfloat16),
    "reduced_f32": (16, 8, 2, 6, 1, 256, 128, torch.float32),
}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_case(name, device, seed=0):
    """Tokens, each routed to top_k distinct experts (the top of random
    logits, as the router picks them), and the held experts' weights
    drawn as `init_moe` draws them."""
    T, E, K, n, first, d, ff, dt = CASES[name]
    g = torch.Generator(device=device).manual_seed(seed)
    logits = torch.randn((T, E), generator=g, device=device)
    flat_e = torch.sort(logits, dim=-1, descending=True,
                        stable=True).indices[:, :K].reshape(T * K)
    x = torch.randn((T, d), generator=g, device=device).to(dt)

    def uniform(shape, fan_in):
        return ((torch.rand(shape, generator=g, device=device) * 2 - 1)
                / fan_in ** 0.5).to(dt)
    w = {"w_gate": uniform((n, d, ff), d), "w_up": uniform((n, d, ff), d),
         "w_down": uniform((n, ff, d), ff)}
    return x, flat_e.contiguous(), w, K, first, n


def row_err(got, want, rows):
    diff = (got[rows].float() - want[rows].float()).norm(dim=-1)
    return float((diff / want[rows].float().norm(dim=-1)).max())


def plain_with_faults(x, perm, off, w, K):
    """The plain version, and two planted faults: the first entry of the
    first expert with rows reads the row of the next token's entry; that
    expert's rows are computed with the next expert's weights."""
    want = moe_experts_ref(x, perm, off, **w, top_k=K, act="silu")
    counts = (off[1:-1] - off[:-2]).tolist()
    e = next(i for i, c in enumerate(counts[:-1]) if c)
    lo, hi = int(off[e]), int(off[e + 1])
    act = ACTIVATIONS["silu"]

    def expert(rows, k):
        return (act(rows @ w["w_gate"][k]) * (rows @ w["w_up"][k])) \
            @ w["w_down"][k]
    i = int(perm[lo])
    neighbour = want.clone()
    neighbour[i] = expert(x[(i // K + 1) % x.shape[0]][None], e)[0]
    entries = perm[lo:hi].long()
    next_expert = want.clone()
    next_expert[entries] = expert(x[entries // K], e + 1)
    return want, {"neighbouring_row": neighbour,
                  "next_experts_weights": next_expert}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_its_plain_version(device, name):
    x, flat_e, w, K, first, n = make_case(name, device)
    perm, off = ME.moe_dispatch(flat_e, first, n)
    perm_ref, off_ref = moe_dispatch_ref(flat_e, first, n)
    assert torch.equal(perm, perm_ref) and torch.equal(off, off_ref)
    before = ME.moe_experts.launches
    y = ME.moe_experts(x, perm, off, **w, top_k=K, act="silu")
    y2 = ME.moe_experts(x, perm, off, **w, top_k=K, act="silu")
    torch.cuda.synchronize()
    assert ME.moe_experts.launches == before + 2
    assert torch.equal(y, y2)
    held = perm[:int(off[n])].long()
    unheld = perm[int(off[n]):].long()
    assert bool((y[unheld] == 0).all())
    want, faults = plain_with_faults(x, perm, off, w, K)
    tol = TOL[x.dtype]
    err = row_err(y, want, held)
    assert err <= tol, (name, err)
    for fault, bad in faults.items():
        assert row_err(bad, want, held) > tol, (name, fault)
        assert row_err(y, bad, held) > tol, (name, fault)


def test_an_expert_with_many_rows_takes_more_passes(device):
    """128 tokens all routed to the same two experts: 128 rows an expert,
    two passes over each weight tile."""
    _, _, w, _, _, _ = make_case("reduced_f32", device)
    x = torch.randn((128, 256), device=device)
    flat_e = torch.tensor([3, 5] * 128, device=device)
    perm, off = ME.moe_dispatch(flat_e, 1, 6)
    y = ME.moe_experts(x, perm, off, **w, top_k=2, act="silu")
    want = moe_experts_ref(x, perm, off, **w, top_k=2, act="silu")
    assert row_err(y, want, torch.arange(256, device=device)) <= 1e-5
    xb = x.to(torch.bfloat16)
    wb = {k: v.to(torch.bfloat16) for k, v in w.items()}
    yb = ME.moe_experts(xb, perm, off, **wb, top_k=2, act="silu")
    wantb = moe_experts_ref(xb, perm, off, **wb, top_k=2, act="silu")
    assert row_err(yb, wantb, torch.arange(256, device=device)) <= 2e-2


def test_refusals(device):
    x, flat_e, w, K, first, n = make_case("reduced_f32", device)
    perm, off = ME.moe_dispatch(flat_e, first, n)
    cut = {k: (v[..., :192] if k == "w_down" else v[:, :192]).contiguous()
           for k, v in w.items()}
    with pytest.raises(ValueError):             # d 192: no multiple of 128
        ME.moe_experts(x[:, :192].contiguous(), perm, off, **cut, top_k=K,
                       act="silu")
    with pytest.raises(ValueError):
        ME.moe_experts(x.to(torch.bfloat16), perm, off, **w, top_k=K,
                       act="silu")
    with pytest.raises(ValueError, match="SiLU"):   # the one activation
        ME.moe_experts(x, perm, off, **w, top_k=K, act="gelu")
    with pytest.raises(NotImplementedError):
        ME.moe_experts(x.requires_grad_(), perm, off, **w, top_k=K,
                       act="silu")
