"""Public wrapper for the Mamba2 SSD scan, the contract of the reference's
`kernels/ssd_scan/ops.ssd_scan` and `models.mamba2.ssd_chunked`.

For CUDA tensors this launches one of the two routes of the hand-written
Hopper kernel (csrc/ssd_scan.cu); for CPU tensors it runs the kernel's
plain PyTorch version (ref.py, the sequential recurrence), because there
is no kernel to run there. That choice is made by the tensors' device
alone: on a CUDA tensor the wrapper launches the kernel or raises, and a
build or launch failure is never answered with the plain version.

The kernel reads x, dt, B and C in the model's layout through their
strides, forms x * dt and dt * A itself and reads B and C per group, so the
reference wrapper's head-major copies and group-to-head repeats are gone.
It masks a ragged last chunk (as `ssd_chunked` pads it, with dt = 0), so a
sequence need not be a multiple of the chunk: the reference wrapper asserts
that it is (ROADMAP.md Queue 3). The reference's `chunk_size` argument is
gone: the plain version is sequential and the kernel picks its own chunk
(64 tokens on the CUDA cores, MMA_CHUNK on the tensor cores), whatever the
model's; the function is the same, only the rounding moves.

The route (`route()`): bf16 inputs whose tiles the tensor cores take (p in
{16, 32, 64, 128}, n a multiple of 16 up to 256, x, B and C with 16-byte
aligned bases and every stride a multiple of 8 elements) run "mma", three
launches; everything else, f32 included, runs "simt", one launch on the
CUDA cores (TF32 would break the f32 tolerance).

`ssd_scan.launches` counts wrapper calls that launched a route (CUDA
tensors only), so a run can show that its main path went through the
kernel; `ssd_scan.route_launches` counts them by route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_D_STATE = 256          # the kernel's shared-memory limit on n
MMA_HEAD_DIMS = (16, 32, 64, 128)   # p the tensor-core route is built for
MMA_CHUNK = 128            # its chunk, the fastest of PERF.md's sweep


def _check_cuda_args(x, dt, A, B, C):
    """Raise ValueError on anything the CUDA kernel does not take."""
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x/B/C dtypes {x.dtype}/{B.dtype}/{C.dtype} must "
                         f"be equal and in {DTYPES}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype} and "
                         f"{A.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4:
        raise ValueError("expected x (b,s,h,p), dt (b,s,h), A (h,), B and C "
                         "(b,s,g,n)")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or B.shape != C.shape or tuple(B.shape[:2]) != (b, s):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if g < 1 or h % g:
        raise ValueError(f"heads {h} not a multiple of groups {g}")
    if not 1 <= n <= MAX_D_STATE:
        raise ValueError(f"d_state {n} not in [1, {MAX_D_STATE}]")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")


def route(x, B, C) -> str:
    """"mma" where the tensor-core route takes these (already checked)
    arguments, else "simt"."""
    if x.dtype != torch.bfloat16 or x.shape[3] not in MMA_HEAD_DIMS \
            or B.shape[3] % 16:
        return "simt"
    for t in (x, B, C):
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            return "simt"
    return "mma"


def ssd_scan(x, dt, A, B, C):
    """x: (b,s,h,p); dt: (b,s,h); A: (h,); B, C: (b,s,g,n). Returns (y
    (b,s,h,p) in x's dtype, final state (b,h,p,n) f32)."""
    if x.device.type == "cpu":
        y, state = ssd_ref(x, dt, A, B, C)
        return y.to(x.dtype), state
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan takes CUDA or CPU tensors, got "
                         f"{x.device}")
    _check_cuda_args(x, dt, A, B, C)
    from repro_torch.kernels.ssd_scan import kernel
    which = route(x, B, C)
    if which == "mma":
        y, state = kernel.ssd_scan_mma_kernel(x, dt, A, B, C, MMA_CHUNK)
    else:
        y, state = kernel.ssd_scan_kernel(x, dt, A, B, C)
    ssd_scan.launches += 1
    ssd_scan.route_launches[which] += 1
    return y, state


ssd_scan.launches = 0
ssd_scan.route_launches = {"mma": 0, "simt": 0}
