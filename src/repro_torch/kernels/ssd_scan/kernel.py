"""Launcher for the hand-written Hopper SSD chunked-scan kernel
(`repro_torch/csrc/ssd_scan.cu`), which replaces the reference's Pallas TPU
kernel `kernels/ssd_scan/kernel.py::_ssd_kernel`.

The kernel is a shared library with a plain C entry point per dtype, built
by `kernels.build` on first use and called through ctypes. This module
launches only; `ops.ssd_scan` checks the arguments first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 7        # x, dt, A, B, C, y, state
             + [ctypes.c_int] * 6         # B, L, H, P, G, N
             + [ctypes.c_void_p,          # strides (12 x int64)
                ctypes.c_void_p])         # stream


@functools.cache
def _entry_points():
    lib = build.load("ssd_scan")
    fns = {}
    for dtype, name in ((torch.float32, "ssd_scan_f32"),
                        (torch.bfloat16, "ssd_scan_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return fns, lib.ssd_scan_error_string


def ssd_scan_kernel(x, dt, A, B, C):
    """x: (b, s, h, p) CUDA f32/bf16; dt: (b, s, h) f32; A: (h,) f32
    contiguous; B, C: (b, s, g, n) in x's dtype; every last dim contiguous,
    other strides free. Returns (y (b, s, h, p) in x's dtype, state (b, h,
    p, n) f32), both contiguous. Raises RuntimeError if the launch is
    refused."""
    fns, err_str = _entry_points()
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    strides = (ctypes.c_int64 * 12)(*x.stride()[:3], *dt.stride(),
                                    *B.stride()[:3], *C.stride()[:3])
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fns[x.dtype](x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                           B.data_ptr(), C.data_ptr(), y.data_ptr(),
                           state.data_ptr(), b, s, h, p, g, n, strides,
                           stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    return y, state
