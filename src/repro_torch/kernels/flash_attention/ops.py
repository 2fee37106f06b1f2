"""Public wrapper for flash attention (causal self-attention prefill).

For CUDA tensors this launches the hand-written Hopper kernel
(csrc/flash_attention.cu); for CPU tensors it runs the kernel's plain
PyTorch version (ref.py), because there is no kernel to run there. That
choice is made by the tensors' device alone: on a CUDA tensor the wrapper
launches the kernel or raises, and a build or launch failure is never
answered with the plain version.

The kernel reads q, k and v in the reference's (B, S, heads, hd) layout
through their strides and masks the ragged edges of Sq and Sk itself, so
the reference wrapper's pad-to-block copies are gone. bf16 runs on the
tensor cores and f32 on the CUDA cores (TF32 would break the f32
tolerance); the bf16 kernel copies rows 16 bytes at a time, so it refuses
a base pointer that is not 16-byte aligned or a stride that is not a
multiple of 8 elements. Like the reference
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
    """Raise ValueError on anything the CUDA kernel does not take. Runs on
    every launch, so each tensor attribute is read once."""
    dev, dt = q.device, q.dtype
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != dt:
            raise ValueError(f"{name} dtype {t.dtype} must equal q's {dt}")
    if dt not in DTYPES:
        raise ValueError(f"q dtype {dt} not in {DTYPES}")
    qs, ks, vs = q.shape, k.shape, v.shape
    if len(qs) != 4 or len(ks) != 4 or len(vs) != 4:
        raise ValueError("expected q (B,Sq,nh,hd), k and v (B,Sk,nkv,hd)")
    B, Sq, nh, hd = qs
    if ks != vs or ks[0] != B or ks[3] != hd:
        raise ValueError(f"k {tuple(ks)} / v {tuple(vs)} do not match q "
                         f"{tuple(qs)}")
    nkv = ks[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if nkv < 1 or nh % nkv:
        raise ValueError(f"n_heads {nh} not a multiple of n_kv_heads {nkv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    bf16 = dt == torch.bfloat16
    for name, t, n in (("q", q, qs), ("k", k, ks), ("v", v, vs)):
        st = t.stride()
        if st[3] != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
        # the bf16 kernel copies rows by 16-byte cp.async: every row start
        # must be 16-byte aligned (the f32 kernel reads element by element)
        if bf16 and (t.data_ptr() % 16 or (st[0] % 8 and n[0] > 1)
                     or (st[1] % 8 and n[1] > 1) or (st[2] % 8 and n[2] > 1)):
            raise ValueError(f"{name}: the bf16 kernel needs a 16-byte-"
                             f"aligned base and strides that are multiples "
                             f"of 8 elements, got strides {st}")


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
