"""Launcher for the hand-written Hopper grouped MoE experts kernel
(`repro_torch/csrc/moe_experts.cu`). It replaces no TPU kernel: the
reference's expert products are `jnp.einsum` over a GShard buffer.

The kernel is a shared library with plain C entry points (the dispatch's
one-block sort, and gate/up then down per dtype), built by `kernels.build`
on first use and called through ctypes: pointers come from
`tensor.data_ptr()`, the stream from PyTorch's current stream. This module
launches only; `ops` checks the arguments first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DISPATCH_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int]          # flat_e, N, first, n
                      + [ctypes.c_void_p] * 3)  # perm, offsets, stream
_EXPERTS_ARGTYPES = ([ctypes.c_void_p] * 8    # x, perm, offsets, w_gate,
                                              # w_up, w_down, h scratch, y
                     + [ctypes.c_int] * 5     # N, top_k, d, ff, n
                     + [ctypes.c_void_p])     # stream


@functools.cache
def _entry_points():
    lib = build.load("moe_experts")
    lib.moe_dispatch.argtypes = _DISPATCH_ARGTYPES
    lib.moe_dispatch.restype = ctypes.c_int
    fns = {}
    for dtype, name in ((torch.float32, "moe_experts_f32"),
                        (torch.bfloat16, "moe_experts_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = _EXPERTS_ARGTYPES
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    lib.moe_experts_error_string.argtypes = [ctypes.c_int]
    lib.moe_experts_error_string.restype = ctypes.c_char_p
    return lib.moe_dispatch, fns, lib.moe_experts_error_string


def _raise(what: str, err: int, err_str):
    raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                       f"({err_str(err).decode()})")


def moe_dispatch_kernel(flat_e, first: int, n: int):
    """flat_e: (N,) int64 CUDA. Returns (perm (N,), offsets (n + 2,))
    int32."""
    dispatch, _, err_str = _entry_points()
    N = flat_e.shape[0]
    out = torch.empty(N + n + 2, dtype=torch.int32, device=flat_e.device)
    perm, offsets = out[:N], out[N:]
    with build.on_device(flat_e.device):
        err = dispatch(flat_e.data_ptr(), N, first, n, perm.data_ptr(),
                       offsets.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    if err != 0:
        _raise("moe_dispatch", err, err_str)
    return perm, offsets


def moe_experts_kernel(x, perm, offsets, w_gate, w_up, w_down, *,
                       top_k: int):
    """x: (T, d) CUDA f32/bf16; perm, offsets from `moe_dispatch_kernel`;
    w_gate, w_up: (n, d, ff), w_down: (n, ff, d) in x's dtype. Launches
    gate/up and down; returns y (N, d) in x's dtype."""
    _, fns, err_str = _entry_points()
    N, d = perm.shape[0], x.shape[1]
    n, _, ff = w_gate.shape
    h = torch.empty((N, ff), dtype=x.dtype, device=x.device)
    y = torch.empty((N, d), dtype=x.dtype, device=x.device)
    with build.on_device(x.device):
        err = fns[x.dtype](x.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
                           w_gate.data_ptr(), w_up.data_ptr(),
                           w_down.data_ptr(), h.data_ptr(), y.data_ptr(), N,
                           top_k, d, ff, n,
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        _raise("moe_experts", err, err_str)
    return y
