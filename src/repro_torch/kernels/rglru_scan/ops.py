"""Public wrapper for the RG-LRU scan y_t = a_t * y_{t-1} + b_t.

For CUDA tensors this launches the hand-written Hopper kernel
(csrc/rglru_scan.cu); for CPU tensors it runs the kernel's plain PyTorch
version (ref.py), because there is no kernel to run there. That choice is
made by the tensors' device alone: on a CUDA tensor the wrapper launches
the kernel or raises, and a build or launch failure is never answered with
the plain version. The kernel masks ragged S and C itself, so the
reference wrapper's identity padding (a = 1, b = 0) is gone. It scans
tiles of CHUNK time steps by 128 channels in one pass over memory, each
tile's carry folded from the aggregates of the earlier ones in chunk order
(ref.py's `rglru_chunked_ref` is the same arithmetic in plain PyTorch).

`rglru_scan.launches` counts kernel launches (CUDA tensors only), so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.ref import rglru_ref

DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 64      # time steps a tile, the fastest of PERF.md's sweep


def _check_cuda_args(a, b):
    """Raise ValueError on anything the CUDA kernel does not take."""
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise ValueError(f"a/b dtypes {a.dtype}/{b.dtype} must be equal and "
                         f"in {DTYPES}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"expected a and b (B, S, C) of one shape, got "
                         f"{tuple(a.shape)} / {tuple(b.shape)}")
    if not a.is_contiguous() or not b.is_contiguous():
        raise ValueError("a and b must be contiguous")


def rglru_scan(a, b):
    """a, b: (B, S, C), S >= 1. Returns (y (B, S, C) f32, h_final (B, C)
    f32) with y_t = a_t * y_{t-1} + b_t from h = 0 and h_final = y[:, -1]."""
    if a.shape[1] < 1:
        raise ValueError("rglru_scan needs at least one time step")
    if a.device.type == "cpu":
        y = rglru_ref(a, b)
        return y, y[:, -1]
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan takes CUDA or CPU tensors, got "
                         f"{a.device}")
    _check_cuda_args(a, b)
    if a.numel() == 0:
        y = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
        return y, y[:, -1]
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_kernel
    y = rglru_scan_kernel(a, b, CHUNK)
    rglru_scan.launches += 1
    return y, y[:, -1]


rglru_scan.launches = 0
