"""Plain PyTorch version of paged-attention decode: the dense-gather path.

The port of the reference oracle (`kernels/paged_attention/ref.py`) and the
function the hand-written kernel is held against. It gathers each slot's
page chain into a dense (B, nb*bs, nkv, hd) view over the block table, masks,
softmaxes and takes the weighted sum. Positions beyond the query (causal),
outside the optional window, or on pages mapped to the reserved null block 0
are masked out, and a fully masked slot row (an empty slot: all-zero table)
yields zeros, as the kernel's skipped-page finalize does.
"""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q, kpool, vpool, table, pos, *, scale=None,
                        window=None):
    """q: (B, nh, hd); kpool/vpool: (P, bs, nkv, hd); table: (B, nb) int32
    block ids; pos: (B,) int32 query positions. Returns (B, nh, hd)."""
    B, nh, hd = q.shape
    _, bs, nkv, _ = kpool.shape
    nb = table.shape[1]
    rep = nh // nkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    idx = table.long()
    k = kpool[idx].reshape(B, nb * bs, nkv, hd)
    v = vpool[idx].reshape(B, nb * bs, nkv, hd)
    kv_pos = torch.arange(nb * bs, device=q.device)[None, :]
    valid = kv_pos <= pos[:, None]
    if window is not None:
        valid &= kv_pos > (pos[:, None] - window)
    valid &= (table != 0).repeat_interleave(bs, dim=1)   # reserved null page
    qr = q.reshape(B, nkv, rep, hd)
    logits = torch.einsum("bkrh,bskh->bkrs", qr.float(), k.float()) * scale
    logits = logits.masked_fill(~valid[:, None, None, :], -math.inf)
    w = torch.softmax(logits, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)                     # fully masked rows -> 0
    out = torch.einsum("bkrs,bskh->bkrh", w, v.float())
    return out.reshape(B, nh, hd).to(q.dtype)
