"""Public wrapper for paged-attention decode.

``kernel="cuda"`` is the hand-written Hopper kernel (csrc/paged_attention.cu)
for CUDA tensors. For CPU tensors it runs the kernel's plain PyTorch version
(ref.py), because there is no kernel to run there; that choice is made by
the tensors' device alone. On a CUDA tensor the wrapper launches the kernel
or raises: a build or launch failure is never answered with the plain
version. ``kernel="reference"`` runs the plain dense-gather version on any
device (the engine's oracle path).

The paged layout is position-addressed (a page's gather index IS its
absolute position), so sliding-window ring semantics cannot be expressed
over a block table: window must be None with kernel="cuda", as with the
reference's pallas kernel. The reference path accepts a window.

`paged_attention.launches` counts kernel launches (CUDA tensors only), so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_attention.ref import paged_attention_ref

KERNELS = ("cuda", "reference")
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda_args(q, kpool, vpool, table, pos):
    """Raise ValueError on anything the CUDA kernel does not take."""
    dev = q.device
    for name, t in (("kpool", kpool), ("vpool", vpool), ("table", table),
                    ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {DTYPES}")
    if kpool.dtype != q.dtype or vpool.dtype != q.dtype:
        raise ValueError(f"kpool/vpool dtypes {kpool.dtype}/{vpool.dtype} "
                         f"must equal q's {q.dtype}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"table/pos must be int32, got {table.dtype}/"
                         f"{pos.dtype}")
    if q.dim() != 3 or kpool.dim() != 4 or table.dim() != 2 or pos.dim() != 1:
        raise ValueError("expected q (B,nh,hd), pools (P,bs,nkv,hd), table "
                         "(B,nb), pos (B,)")
    B, nh, hd = q.shape
    P, bs, nkv, hd_kv = kpool.shape
    if vpool.shape != kpool.shape:
        raise ValueError(f"vpool {tuple(vpool.shape)} != kpool "
                         f"{tuple(kpool.shape)}")
    if hd_kv != hd or hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (pool {hd_kv}) must match and be "
                         f"one of {HEAD_DIMS}")
    if nkv < 1 or nh % nkv:
        raise ValueError(f"n_heads {nh} not a multiple of n_kv_heads {nkv}")
    if table.shape[0] != B or pos.shape[0] != B:
        raise ValueError(f"table {tuple(table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {B}")
    if P < 1 or bs < 1 or table.shape[1] < 1:
        raise ValueError("empty pool or table")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool),
                    ("table", table), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention(q, kpool, vpool, table, pos, *, scale=None, window=None,
                    kernel="cuda"):
    """q: (B, nh, hd) single query token per slot; kpool/vpool:
    (P, bs, nkv, hd); table: (B, nb) int32; pos: (B,) int32. Returns
    (B, nh, hd) in q's dtype."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel == "cuda" and window is not None:
        raise ValueError("paged-attention cuda kernel supports window=None "
                         "only (paged chains are position-addressed, not a "
                         "ring); use kernel='reference' for sliding-window "
                         "decode")
    if kernel == "reference" or q.device.type == "cpu":
        return paged_attention_ref(q, kpool, vpool, table, pos, scale=scale,
                                   window=window)
    if q.device.type != "cuda":
        raise ValueError(f"kernel='cuda' takes CUDA or CPU tensors, got "
                         f"{q.device}")
    _check_cuda_args(q, kpool, vpool, table, pos)
    if q.shape[0] == 0:
        return torch.empty_like(q)
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_kernel
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out = paged_attention_kernel(q, kpool, vpool, table, pos, scale=scale)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
