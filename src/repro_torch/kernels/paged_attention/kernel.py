"""Launcher for the hand-written Hopper paged-attention decode kernel
(`repro_torch/csrc/paged_attention.cu`), which replaces the reference's
Pallas TPU kernel `kernels/paged_attention/kernel.py::_paged_attn_kernel`.

The kernel is a shared library with a plain C entry point per dtype, built
by `kernels.build` on first use and called through ctypes: pointers come
from `tensor.data_ptr()`, the stream from PyTorch's current stream. This
module launches only; `ops.paged_attention` checks the arguments first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 8        # q, kpool, vpool, table, pos, out,
                                          # acc and ml scratch
             + [ctypes.c_int] * 9         # B, nh, nkv, hd, bs, nb, n_pool,
                                          # n_splits, pages per split
             + [ctypes.c_float, ctypes.c_void_p])   # scale, stream


@functools.cache
def _entry_points():
    lib = build.load("paged_attention")
    fns = {}
    for dtype, name in ((torch.float32, "paged_attention_f32"),
                        (torch.bfloat16, "paged_attention_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    lib.paged_attention_error_string.argtypes = [ctypes.c_int]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return fns, lib.paged_attention_error_string


def paged_attention_kernel(q, kpool, vpool, table, pos, *, scale: float,
                           n_splits: int, pages_per_split: int):
    """q: (B, nh, hd) CUDA f32/bf16; kpool/vpool: (P, bs, nkv, hd) same
    dtype; table: (B, nb) int32; pos: (B,) int32. Split s of every chain
    covers pages [s * pages_per_split, (s + 1) * pages_per_split)
    (`ops.split_plan`). Launches the split pass and the combine pass;
    returns (B, nh, hd) in q's dtype. Raises RuntimeError if a launch is
    refused."""
    fns, err_str = _entry_points()
    B, nh, hd = q.shape
    P, bs, nkv, _ = kpool.shape
    nb = table.shape[1]
    out = torch.empty_like(q)
    # each split's f32 partial in one allocation: the unnormalised
    # accumulator (B, nh, n_splits, hd), then (running max, sum) pairs
    n_acc = B * nh * n_splits * hd
    scratch = torch.empty(n_acc + B * nh * n_splits * 2, dtype=torch.float32,
                          device=q.device)
    acc = scratch.data_ptr()
    with build.on_device(q.device):
        err = fns[q.dtype](q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                           table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                           acc, acc + 4 * n_acc, B, nh, nkv, hd, bs, nb, P,
                           n_splits, pages_per_split, float(scale),
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
    return out
