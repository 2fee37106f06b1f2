"""Plain PyTorch version of flash attention: exact masked softmax attention.

The port of the reference oracle (`kernels/flash_attention/ref.py::
attention_ref`) and the function the hand-written kernel is held against.
It repeats each KV head over its group of query heads, takes the f32
logits, masks (causal, sliding window), softmaxes and takes the weighted
sum. A fully masked row yields zeros, as the kernel's `l == 0` finalize
does.

`paged_prefill_ref` is the plain version of the paged variant: the paged
bulk prefill's read as the reference computes it (its dense XLA
composition, `models/layers.py::_sdpa_xla`), over every page of the slot's
table.
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


def paged_prefill_ref(q, kpool, vpool, table, start, n_tok, *, window=None,
                      scale=None):
    """q: (1, S, nh, hd), row i at absolute position start + i; kpool,
    vpool: (n_blocks, bs, nkv, hd); table: (nb,) the slot's block ids ->
    (1, S, nh, hd) in q's dtype. Gathers all nb pages, masks causally by
    absolute position (and the window) and runs `_sdpa_xla`. Rows at or
    past `n_tok` are padding: their outputs are whatever the mask gives
    them (the kernel writes zeros there)."""
    from repro_torch.models.layers import _sdpa_xla
    S, hd = q.shape[1], q.shape[3]
    bs, nkv = kpool.shape[1], kpool.shape[2]
    nb = table.shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q_pos = start + torch.arange(S, device=q.device)
    kall = kpool[table.long()].reshape(1, nb * bs, nkv, hd)
    vall = vpool[table.long()].reshape(1, nb * bs, nkv, hd)
    kv_pos = torch.arange(nb * bs, device=q.device)
    mask = kv_pos[None, :] <= q_pos[:, None]         # causal, absolute
    if window is not None:
        mask &= kv_pos[None, :] > (q_pos[:, None] - window)
    return _sdpa_xla(q, kall, vall, mask[None], scale)
