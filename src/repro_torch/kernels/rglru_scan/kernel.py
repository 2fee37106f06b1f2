"""Launcher for the hand-written Hopper RG-LRU scan kernel
(`repro_torch/csrc/rglru_scan.cu`), which replaces the reference's Pallas
TPU kernel `kernels/rglru_scan/kernel.py::_rglru_kernel`.

The kernel is a shared library with a plain C entry point per dtype, built
by `kernels.build` on first use and called through ctypes. This module
launches only; `ops.rglru_scan` checks the arguments first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 5        # a, b, y, and the scratch agg,
                                          # flags
             + [ctypes.c_int] * 4         # B, S, C, chunk
             + [ctypes.c_void_p])         # stream
_CHANNELS = 128                           # channels of a tile (the kernel's)


@functools.cache
def _entry_points():
    lib = build.load("rglru_scan")
    fns = {}
    for dtype, name in ((torch.float32, "rglru_scan_f32"),
                        (torch.bfloat16, "rglru_scan_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return fns, lib.rglru_scan_error_string


def rglru_scan_kernel(a, b, chunk):
    """a, b: (B, S, C) contiguous CUDA f32/bf16 of one dtype; `chunk` in
    {32, 64, 128} time steps a tile. Returns y (B, S, C) f32. Allocates the
    tiles' aggregates and ready flags (the C side zeroes the flags with a
    memset on the stream, then launches the kernel). Raises RuntimeError if
    the launch is refused."""
    fns, err_str = _entry_points()
    B, S, C = a.shape
    tiles = B * -(-C // _CHANNELS) * -(-S // chunk)
    y = torch.empty((B, S, C), dtype=torch.float32, device=a.device)
    # one allocation: the aggregates (float2 per channel of a tile), then
    # the flags and the ticket (int32)
    scratch = torch.empty((tiles * _CHANNELS * 2 + tiles + 1,),
                          dtype=torch.float32, device=a.device)
    agg = scratch.data_ptr()
    flags = agg + tiles * _CHANNELS * 8
    with build.on_device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fns[a.dtype](a.data_ptr(), b.data_ptr(), y.data_ptr(), agg,
                           flags, B, S, C, chunk, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    return y
