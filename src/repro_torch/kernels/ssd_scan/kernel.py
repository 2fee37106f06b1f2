"""Launcher for the hand-written Hopper SSD chunked-scan kernel
(`repro_torch/csrc/ssd_scan.cu`), which replaces the reference's Pallas TPU
kernel `kernels/ssd_scan/kernel.py::_ssd_kernel`.

The kernel is a shared library with plain C entry points, built by
`kernels.build` on first use and called through ctypes: the CUDA-core route
per dtype (`ssd_scan_kernel`, one launch) and the bf16 tensor-core route
(`ssd_scan_mma_kernel`, three launches over scratch allocated here). This
module launches only; `ops.ssd_scan` checks the arguments and picks the
route first.
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
_MMA_ARGTYPES = ([ctypes.c_void_p] * 10   # x, dt, A, B, C, y, state, and
                                          # the scratch sc, sin, acs
                 + [ctypes.c_int] * 7     # B, L, H, P, G, N, Q
                 + [ctypes.c_void_p,      # strides (12 x int64)
                    ctypes.c_void_p])     # stream


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
    mma = lib.ssd_scan_mma_bf16
    mma.argtypes = _MMA_ARGTYPES
    mma.restype = ctypes.c_int
    fns["mma"] = mma
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return fns, lib.ssd_scan_error_string


def _strides(x, dt, B, C):
    return (ctypes.c_int64 * 12)(*x.stride()[:3], *dt.stride(),
                                 *B.stride()[:3], *C.stride()[:3])


def _outputs(x, n):
    b, s, h, p = x.shape
    return (torch.empty((b, s, h, p), dtype=x.dtype, device=x.device),
            torch.empty((b, h, p, n), dtype=torch.float32, device=x.device))


def _raise_on(err, err_str):
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")


def ssd_scan_kernel(x, dt, A, B, C):
    """The CUDA-core route. x: (b, s, h, p) CUDA f32/bf16; dt: (b, s, h)
    f32; A: (h,) f32 contiguous; B, C: (b, s, g, n) in x's dtype; every last
    dim contiguous, other strides free. Returns (y (b, s, h, p) in x's
    dtype, state (b, h, p, n) f32), both contiguous. Raises RuntimeError if
    the launch is refused."""
    fns, err_str = _entry_points()
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y, state = _outputs(x, n)
    with build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fns[x.dtype](x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                           B.data_ptr(), C.data_ptr(), y.data_ptr(),
                           state.data_ptr(), b, s, h, p, g, n,
                           _strides(x, dt, B, C), stream)
    _raise_on(err, err_str)
    return y, state


def ssd_scan_mma_kernel(x, dt, A, B, C, chunk):
    """The tensor-core route: as `ssd_scan_kernel`, for bf16 x, B and C
    with p in {16, 32, 64, 128}, n a multiple of 16 up to 256, 16-byte
    aligned bases and strides that are multiples of 8 elements (ops.py
    checks); `chunk` in {64, 128, 256} tokens. Three launches over scratch
    allocated here in one piece: the chunks' end states (f32), the states
    entering them (bf16) and the in-chunk cumsums of dt * A."""
    fns, err_str = _entry_points()
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = -(-s // chunk)
    y, state = _outputs(x, n)
    dev = x.device
    # one allocation for the three scratch arrays (each size a multiple of
    # 16 bytes: p and n are multiples of 16, chunk of 64)
    states = b * h * nc * p * n
    scratch = torch.empty((states * 6 + b * h * nc * chunk * 4,),
                          dtype=torch.uint8, device=dev)
    sc = scratch.data_ptr()                  # f32 end states
    sin = sc + states * 4                    # bf16 entering states
    acs = sin + states * 2                   # f32 in-chunk cumsums
    with build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fns["mma"](x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                         B.data_ptr(), C.data_ptr(), y.data_ptr(),
                         state.data_ptr(), sc, sin, acs, b, s, h, p, g, n,
                         chunk, _strides(x, dt, B, C), stream)
    _raise_on(err, err_str)
    return y, state
