"""Public wrappers for the grouped MoE experts: the dispatch (`moe_dispatch`)
and the experts' products (`moe_experts`) over the live (token, expert)
entries, for the dispatch groups in which no entry can be dropped
(`models/moe.py` decides).

For CUDA tensors both run the hand-written Hopper kernel
(csrc/moe_experts.cu). For CPU tensors they run its plain PyTorch version
(ref.py), because there is no kernel to run there; that choice is made by
the tensors' device alone. On a CUDA tensor a wrapper launches the kernel
or raises: a build or launch failure is never answered with the plain
version.

The kernel has no backward (`kernels.refuse_grad`): with grad enabled and
an input that requires one, `moe_experts` raises on every device.

`moe_experts.launches` counts the calls that launched the experts' kernel
(CUDA tensors only; one per call, gate/up and down together), so a run can
show that its MoE went through it. It counts through `kernels.count_launch`:
a call made while a CUDA graph is captured counts when the graph is
replayed (`serve.graph`).

`takes` says which experts the kernel takes: widths that are multiples of
its tiles, at most MAX_HELD held experts, f32 or bf16, and SiLU (the
activation of every MoE config of the port). `models/moe.py` takes the
grouped path only for such experts, on every device, so the choice rests on
the shapes and never on a failure.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import count_launch, refuse_grad
from repro_torch.kernels.moe_experts.ref import (moe_dispatch_ref,
                                                 moe_experts_ref)

DTYPES = (torch.float32, torch.bfloat16)
ACTS = ("silu", "swish")      # the kernel's one activation, by its names
MAX_HELD = 256          # the dispatch's shared-memory table
D_TILE, FF_TILE = 128, 64


def takes(d: int, ff: int, n: int, dtype, act: str) -> bool:
    """Whether the kernel takes n held experts of width d and hidden ff,
    in `dtype`, with activation `act`."""
    return (d % D_TILE == 0 and ff % FF_TILE == 0 and 1 <= n <= MAX_HELD
            and dtype in DTYPES and act in ACTS)


def moe_dispatch(flat_e, first: int, n: int):
    """flat_e: (N,) int64 expert per entry (entry i is token i // top_k's
    choice). Returns (perm (N,) int32, offsets (n + 2,) int32): the entries
    of held expert e (first .. first + n - 1) are perm[offsets[e]:
    offsets[e + 1]] in entry order, those of experts not held
    perm[offsets[n]:]."""
    if flat_e.device.type == "cpu":
        return moe_dispatch_ref(flat_e, first, n)
    if flat_e.device.type != "cuda":
        raise ValueError(f"moe_dispatch takes CUDA or CPU tensors, got "
                         f"{flat_e.device}")
    if flat_e.dtype != torch.int64 or flat_e.dim() != 1 or \
            not flat_e.is_contiguous():
        raise ValueError(f"flat_e must be a contiguous (N,) int64 tensor, "
                         f"got {tuple(flat_e.shape)} {flat_e.dtype}")
    if not 1 <= n <= MAX_HELD:
        raise ValueError(f"{n} held experts; the kernel takes 1 to "
                         f"{MAX_HELD}")
    from repro_torch.kernels.moe_experts.kernel import moe_dispatch_kernel
    return moe_dispatch_kernel(flat_e, first, n)


def _check_cuda_args(x, perm, offsets, w_gate, w_up, w_down, top_k, act):
    """Raise ValueError on anything the CUDA kernel does not take."""
    dev, dt = x.device, x.dtype
    if dt not in DTYPES:
        raise ValueError(f"x dtype {dt} not in {DTYPES}")
    if act not in ACTS:
        raise ValueError(f"activation {act!r} not in {ACTS}: the kernel "
                         "runs SiLU only")
    for name, t in (("perm", perm), ("offsets", offsets), ("w_gate", w_gate),
                    ("w_up", w_up), ("w_down", w_down)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if t.dtype != dt:
            raise ValueError(f"{name} dtype {t.dtype} must equal x's {dt}")
    if perm.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise ValueError("perm and offsets must be int32")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (T, d) tensor, got "
                         f"{tuple(x.shape)}")
    T, d = x.shape
    n, d_g, ff = w_gate.shape
    if w_up.shape != w_gate.shape or tuple(w_down.shape) != (n, ff, d) or \
            d_g != d:
        raise ValueError(f"expert weights {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if d % D_TILE or ff % FF_TILE:
        raise ValueError(f"d {d} must be a multiple of {D_TILE} and ff {ff} "
                         f"of {FF_TILE}")
    if tuple(offsets.shape) != (n + 2,) or tuple(perm.shape) != (T * top_k,):
        raise ValueError(f"perm {tuple(perm.shape)} / offsets "
                         f"{tuple(offsets.shape)} do not fit {T} tokens and "
                         f"{n} experts")
    for name, t in (("x", x), ("w_gate", w_gate), ("w_up", w_up),
                    ("w_down", w_down)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def moe_experts(x, perm, offsets, w_gate, w_up, w_down, *, top_k: int,
                act: str):
    """x: (T, d) tokens; perm, offsets: `moe_dispatch`'s over the T *
    top_k entries; w_gate, w_up: (n, d, ff), w_down: (n, ff, d), the held
    experts' weights. Returns y (T * top_k, d) in x's dtype: entry i's row
    is (act(x_t Wg[e]) * (x_t Wu[e])) Wd[e] for its token t = i // top_k
    and held expert e, zeros for an entry of an expert not held. Forward
    only (`refuse_grad`)."""
    refuse_grad("moe_experts", x, w_gate, w_up, w_down)
    if x.device.type == "cpu":
        return moe_experts_ref(x, perm, offsets, w_gate, w_up, w_down,
                               top_k=top_k, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"moe_experts takes CUDA or CPU tensors, got "
                         f"{x.device}")
    _check_cuda_args(x, perm, offsets, w_gate, w_up, w_down, top_k, act)
    from repro_torch.kernels.moe_experts.kernel import moe_experts_kernel
    y = moe_experts_kernel(x, perm, offsets, w_gate, w_up, w_down,
                           top_k=top_k)
    count_launch(moe_experts)
    return y


moe_experts.launches = 0
