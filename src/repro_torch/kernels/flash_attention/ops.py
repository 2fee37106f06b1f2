"""Public wrapper for flash attention (causal self-attention prefill).

For CUDA tensors this launches the hand-written Hopper kernel
(csrc/flash_attention.cu); for CPU tensors it runs the kernel's plain
PyTorch version (ref.py), because there is no kernel to run there. That
choice is made by the tensors' device alone: on a CUDA tensor the wrapper
launches the kernel or raises, and a build or launch failure is never
answered with the plain version.

The kernel reads q, k and v in the reference's (B, S, heads, hd) layout
through their strides and masks the ragged edges of Sq and Sk itself, so
the reference wrapper's pad-to-block copies are gone. Like the reference
wrapper (`ops.py:37-39`), it takes causal attention only: padded or ragged
keys are safe because no query may see past itself.

`flash_attention.launches` counts kernel launches (CUDA tensors only), so
a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda_args(q, k, v, window):
    """Raise ValueError on anything the CUDA kernel does not take."""
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} must equal q's "
                             f"{q.dtype}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {DTYPES}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q (B,Sq,nh,hd), k and v (B,Sk,nkv,hd)")
    B, Sq, nh, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    nkv = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if nkv < 1 or nh % nkv:
        raise ValueError(f"n_heads {nh} not a multiple of n_kv_heads {nkv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, Sq, nh, hd); k, v: (B, Sk, nkv, hd). Query head h attends KV
    head h // (nh // nkv), keys j <= i and, with a window, j > i - window.
    Returns (B, Sq, nh, hd) in q's dtype."""
    if not causal:
        raise ValueError("flash_attention takes causal attention only, as "
                         "the reference kernel's wrapper does (padded keys "
                         "are hidden by the causal mask); use the dense "
                         "attention path for non-causal attention")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=True, window=window,
                             scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CUDA or CPU tensors, got "
                         f"{q.device}")
    _check_cuda_args(q, k, v, window)
    if q.numel() == 0 or k.shape[1] == 0:
        return torch.zeros_like(q)
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out = flash_attention_kernel(q, k, v, window=window, scale=scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
