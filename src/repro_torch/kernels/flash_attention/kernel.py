"""Launcher for the hand-written Hopper flash-attention kernel
(`repro_torch/csrc/flash_attention.cu`), which replaces the reference's
Pallas TPU kernel `kernels/flash_attention/kernel.py::_attn_kernel`, and
for its paged variant (the paged bulk prefill's read; no TPU counterpart).

The kernel is a shared library with a plain C entry point per dtype and
variant, built by `kernels.build` on first use and called through ctypes.
This module launches only; `ops.flash_attention` and
`ops.flash_attention_paged` check the arguments first.
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
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 5  # q, kpool, vpool, table, out
                   + [ctypes.c_int] * 5   # S, nh, nkv, hd, bs
                   + [ctypes.c_void_p,    # strides (9 x int64)
                      ctypes.c_int, ctypes.c_int,     # start, n_tok
                      ctypes.c_float, ctypes.c_int,   # scale, window
                      ctypes.c_void_p])   # stream


@functools.cache
def _entry_points():
    lib = build.load("flash_attention")
    fns = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for paged, prefix, argtypes in (
                (False, "flash_attention_", _ARGTYPES),
                (True, "flash_attention_paged_", _PAGED_ARGTYPES)):
            fn = getattr(lib, prefix + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[dtype, paged] = fn
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return fns, lib.flash_attention_error_string


def _raise_on(err, err_str, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")


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
        err = fns[q.dtype, False](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, nh, nkv, hd, strides, float(scale),
            -1 if window is None else int(window),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, err_str, "flash_attention")
    return out


def flash_attention_paged_kernel(q, kpool, vpool, table, start: int,
                                 n_tok: int, *, window, scale: float):
    """q: (1, S, nh, hd) CUDA f32/bf16, row i at position start + i;
    kpool, vpool: (n_blocks, bs, nkv, hd) same dtype, the last dim
    contiguous; table: (nb,) contiguous int32. Returns a contiguous (1, S,
    nh, hd) tensor in q's dtype, zero at rows >= n_tok (1 <= n_tok <= S).
    Raises RuntimeError if the launch is refused."""
    fns, err_str = _entry_points()
    _, S, nh, hd = q.shape
    bs, nkv = kpool.shape[1], kpool.shape[2]
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *kpool.stride()[:3],
                                   *vpool.stride()[:3])
    out = torch.empty((1, S, nh, hd), dtype=q.dtype, device=q.device)
    with build.on_device(q.device):
        err = fns[q.dtype, True](
            q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
            table.data_ptr(), out.data_ptr(), S, nh, nkv, hd, bs, strides,
            int(start), int(n_tok), float(scale),
            -1 if window is None else int(window),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, err_str, "flash_attention_paged")
    return out
