"""Plain PyTorch version of flash attention: exact masked softmax attention.

The port of the reference oracle (`kernels/flash_attention/ref.py::
attention_ref`) and the function the hand-written kernel is held against.
It repeats each KV head over its group of query heads, takes the f32
logits, masks (causal, sliding window), softmaxes and takes the weighted
sum. A fully masked row yields zeros, as the kernel's `l == 0` finalize
does.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, Sq, nh, hd); k, v: (B, Sk, nkv, hd) -> (B, Sq, nh, hd) in q's
    dtype."""
    B, Sq, nh, hd = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    rep = nh // nkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = k.repeat_interleave(rep, dim=2).float()
    vf = v.repeat_interleave(rep, dim=2).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, -math.inf)
    w = torch.softmax(logits, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)          # fully-masked rows -> zero output
    out = torch.einsum("bhqk,bkhd->bqhd", w, vf)
    return out.to(q.dtype)
