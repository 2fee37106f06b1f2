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

There is no backward (`kernels.refuse_grad`): with grad enabled and an
input that requires one, the wrapper raises on every device, CPU tensors
too, as the reference's kernel refuses `jax.grad`.

`flash_attention.launches` counts kernel launches (CUDA tensors only), so
a run can show that its main path went through the kernel.

`flash_attention_paged` is the paged variant, the paged bulk prefill's
attention read (`models/layers.py::attention_prefill_paged`), a port-only
kernel: the reference computes that read with its dense XLA composition,
which CPU tensors run here (`ref.paged_prefill_ref`). It takes the same
rules: the device alone picks the path, no backward, the same dtypes, head
dims and alignment. Its own counter, `flash_attention_paged.launches`,
counts one launch per call on CUDA tensors; gateway replicas prefill on
threads of their own, so it counts through `kernels.count_launch`, under
its lock.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import count_launch, refuse_grad
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     paged_prefill_ref)

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
    Returns (B, Sq, nh, hd) in q's dtype. Forward only, on every device
    (`refuse_grad`)."""
    refuse_grad("flash_attention", q, k, v)
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


def _check_paged_args(q, kpool, vpool, table, start, n_tok, window):
    """Raise ValueError on anything the paged CUDA kernel does not take.
    Reads host attributes only: no device sync."""
    dev, dt = q.device, q.dtype
    for name, t in (("kpool", kpool), ("vpool", vpool), ("table", table)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if dt not in DTYPES:
        raise ValueError(f"q dtype {dt} not in {DTYPES}")
    if kpool.dtype != dt or vpool.dtype != dt:
        raise ValueError(f"kpool/vpool dtypes {kpool.dtype}/{vpool.dtype} "
                         f"must equal q's {dt}")
    if table.dtype != torch.int32:
        raise ValueError(f"table must be int32, got {table.dtype}")
    qs, ks = q.shape, kpool.shape
    if len(qs) != 4 or qs[0] != 1 or len(ks) != 4 or table.dim() != 1:
        raise ValueError("expected q (1,S,nh,hd), pools (n_blocks,bs,nkv,hd) "
                         "and table (nb,)")
    _, S, nh, hd = qs
    _, bs, nkv, hd_kv = ks
    if vpool.shape != ks:
        raise ValueError(f"vpool {tuple(vpool.shape)} != kpool {tuple(ks)}")
    if hd_kv != hd or hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (pool {hd_kv}) must match and be "
                         f"one of {HEAD_DIMS}")
    if nkv < 1 or nh % nkv:
        raise ValueError(f"n_heads {nh} not a multiple of n_kv_heads {nkv}")
    if start < 0 or not 0 <= n_tok <= S:
        raise ValueError(f"need start >= 0 and 0 <= n_tok <= {S}, got "
                         f"start={start} n_tok={n_tok}")
    if start + n_tok > table.shape[0] * bs:
        raise ValueError(f"positions up to {start + n_tok} run past the "
                         f"table's {table.shape[0]} pages of {bs}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    bf16 = dt == torch.bfloat16
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool)):
        st, n = t.stride(), t.shape
        if st[3] != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
        # as the dense kernel: 16-byte cp.async rows in bf16
        if bf16 and (t.data_ptr() % 16 or any(
                st[i] % 8 and n[i] > 1 for i in range(3))):
            raise ValueError(f"{name}: the bf16 kernel needs a 16-byte-"
                             f"aligned base and strides that are multiples "
                             f"of 8 elements, got strides {st}")


def flash_attention_paged(q, kpool, vpool, table, start: int, n_tok: int, *,
                          window=None, scale=None):
    """The paged bulk prefill's attention read. q: (1, S, nh, hd), row i at
    absolute position start + i, the first `n_tok` rows real and the rest
    padding; kpool, vpool: (n_blocks, bs, nkv, hd); table: (nb,) int32, the
    slot's block ids, page p holding positions [p * bs, (p + 1) * bs).
    Query head h attends KV head h // (nh // nkv) at keys j <= start + i
    and, with a window, j > start + i - window. Returns (1, S, nh, hd) in
    q's dtype. The kernel writes rows at or past n_tok as zeros; the plain
    version (CPU tensors) leaves them what the mask gives. Forward only, on
    every device (`refuse_grad`)."""
    refuse_grad("flash_attention_paged", q, kpool, vpool)
    if q.device.type == "cpu":
        return paged_prefill_ref(q, kpool, vpool, table, start, n_tok,
                                 window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_paged takes CUDA or CPU tensors, "
                         f"got {q.device}")
    start, n_tok = int(start), int(n_tok)
    _check_paged_args(q, kpool, vpool, table, start, n_tok, window)
    if q.numel() == 0 or n_tok == 0:
        return torch.zeros_like(q)
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_paged_kernel
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out = flash_attention_paged_kernel(q, kpool, vpool, table, start, n_tok,
                                       window=window, scale=scale)
    count_launch(flash_attention_paged)
    return out


flash_attention_paged.launches = 0
