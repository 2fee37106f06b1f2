"""Launcher for the hand-written Hopper flash-attention kernel
(`repro_torch/csrc/flash_attention.cu`), which replaces the reference's
Pallas TPU kernel `kernels/flash_attention/kernel.py::_attn_kernel`.

The kernel is a shared library with a plain C entry point per dtype, built
by `kernels.build` on first use and called through ctypes. This module
launches only; `ops.flash_attention` checks the arguments first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 4        # q, k, v, out
             + [ctypes.c_int] * 6         # B, Sq, Sk, nh, nkv, hd
             + [ctypes.c_void_p,          # strides (9 x int64)
                ctypes.c_float, ctypes.c_int,   # scale, window
                ctypes.c_void_p])         # stream


@functools.cache
def _entry_points():
    lib = build.load("flash_attention")
    fns = {}
    for dtype, name in ((torch.float32, "flash_attention_f32"),
                        (torch.bfloat16, "flash_attention_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return fns, lib.flash_attention_error_string


def flash_attention_kernel(q, k, v, *, window, scale: float):
    """q: (B, Sq, nh, hd) CUDA f32/bf16; k, v: (B, Sk, nkv, hd) same dtype,
    any strides with a contiguous last dim. Returns a contiguous (B, Sq, nh,
    hd) tensor in q's dtype. Raises RuntimeError if the launch is refused."""
    fns, err_str = _entry_points()
    B, Sq, nh, hd = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    out = torch.empty((B, Sq, nh, hd), dtype=q.dtype, device=q.device)
    with build.on_device(q.device):
        err = fns[q.dtype](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), B, Sq, Sk, nh, nkv, hd, strides,
                           float(scale), -1 if window is None else int(window),
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
    return out
