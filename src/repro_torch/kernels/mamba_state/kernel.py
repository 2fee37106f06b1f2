"""Launcher for the hand-written Hopper Mamba2 decode state step
(`repro_torch/csrc/mamba_state.cu`). It replaces no TPU kernel: the
reference's decode step is plain jnp (`models/mamba2.py::ssd_decode_step`).

The kernel is a shared library with plain C entry points, one per dtype of
x, B and C, built by `kernels.build` on first use and called through
ctypes: pointers come from `tensor.data_ptr()`, the stream from PyTorch's
current stream. This module launches only; `ops` checks the arguments
first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 8         # ssm, x, dt, A, B, C, live, y
             + [ctypes.c_int] * 5          # batch, h, p, n, g
             + [ctypes.c_longlong] * 9     # x, B, C strides
             + [ctypes.c_void_p])          # stream


@functools.cache
def _entry_points():
    lib = build.load("mamba_state")
    fns = {}
    for dtype, name in ((torch.float32, "mamba_state_f32"),
                        (torch.bfloat16, "mamba_state_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    lib.mamba_state_error_string.argtypes = [ctypes.c_int]
    lib.mamba_state_error_string.restype = ctypes.c_char_p
    return fns, lib.mamba_state_error_string


def mamba_state_kernel(ssm, x, dt, A, B, C, live):
    """ssm: (b, h, p, n) f32 CUDA, contiguous, stepped in place where live;
    x: (b, h, p), B, C: (b, g, n) in one dtype, any strides; dt:
    (b, h), A: (h,) f32 contiguous; live: (b,) bool. Returns y (b, h, p)
    f32 (zeros in dead rows)."""
    fns, err_str = _entry_points()
    b, h, p = x.shape
    g, n = B.shape[1], B.shape[2]
    y = torch.empty((b, h, p), dtype=torch.float32, device=x.device)
    with build.on_device(x.device):
        err = fns[x.dtype](ssm.data_ptr(), x.data_ptr(), dt.data_ptr(),
                           A.data_ptr(), B.data_ptr(), C.data_ptr(),
                           live.data_ptr(), y.data_ptr(), b, h, p, n, g,
                           *x.stride(), *B.stride(), *C.stride(),
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba_state kernel launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    return y
