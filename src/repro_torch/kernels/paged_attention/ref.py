"""Plain PyTorch version of paged-attention decode: the dense-gather path.

The port of the reference oracle (`kernels/paged_attention/ref.py`) and the
function the hand-written kernel is held against. It gathers each slot's
page chain into a dense (B, nb*bs, nkv, hd) view over the block table, masks,
softmaxes and takes the weighted sum. Positions beyond the query (causal),
outside the optional window, or on pages mapped to the reserved null block 0
are masked out, and a fully masked slot row (an empty slot: all-zero table)
yields zeros, as the kernel's skipped-page finalize does.

`paged_attention_split_ref` is the kernel's two-pass arithmetic in plain
torch, for the tests only: per split of the chain (`ops.split_plan`) the
unnormalised f32 partial (acc, m, l), then the combine in split order.
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


NEG_INF = -1e30     # the reference kernel's running-max start


def paged_attention_split_ref(q, kpool, vpool, table, pos, *, scale=None,
                              plan=None, return_partials=False):
    """The split-and-combine form of `paged_attention_ref`. `plan` is an
    `ops.SplitPlan` (default: `ops.split_plan` of the shapes). Pages after
    pos // bs, block 0 and ids >= n_pool are skipped; a split with nothing
    to attend leaves (acc 0, m -1e30, l 0); a row whose splits are all
    empty is 0. With return_partials, also returns (acc (B, nh, n, hd),
    m (B, nh, n), l (B, nh, n)) in f32."""
    B, nh, hd = q.shape
    P, bs, nkv, _ = kpool.shape
    nb = table.shape[1]
    rep = nh // nkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if plan is None:
        from repro_torch.kernels.paged_attention.ops import split_plan
        plan = split_plan(B, nkv, nb, bs)
    idx = table.long()
    live = (idx > 0) & (idx < P)
    idx = torch.where(live, idx, torch.zeros_like(idx))
    k = kpool[idx].reshape(B, nb * bs, nkv, hd).float()
    v = vpool[idx].reshape(B, nb * bs, nkv, hd).float()
    kv_pos = torch.arange(nb * bs, device=q.device)[None, :]
    valid = (kv_pos <= pos[:, None]) & live.repeat_interleave(bs, dim=1)
    qr = q.reshape(B, nkv, rep, hd).float()
    s = torch.einsum("bkrh,bskh->bkrs", qr, k) * scale
    accs, ms, ls = [], [], []
    for p0, p1 in plan.ranges:
        sl = slice(p0 * bs, p1 * bs)
        ok = valid[:, None, None, sl]
        ss = torch.where(ok, s[..., sl], torch.full_like(s[..., sl], NEG_INF))
        m = ss.amax(dim=-1).clamp_min(NEG_INF)
        p = torch.where(ok, torch.exp(ss - m[..., None]),
                        torch.zeros_like(ss))
        accs.append(torch.einsum("bkrs,bskh->bkrh", p, v[:, sl]))
        ms.append(m)
        ls.append(p.sum(dim=-1))
    acc = torch.stack(accs, dim=3)            # (B, nkv, rep, n, hd)
    m = torch.stack(ms, dim=3)                # (B, nkv, rep, n)
    l = torch.stack(ls, dim=3)
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    total = (l * w).sum(dim=-1)
    o = (acc * w[..., None]).sum(dim=3)
    out = torch.where(total[..., None] > 0, o / total[..., None].clamp_min(
        torch.finfo(torch.float32).tiny), torch.zeros_like(o))
    out = out.reshape(B, nh, hd).to(q.dtype)
    if not return_partials:
        return out
    n = len(plan.ranges)
    return out, (acc.reshape(B, nh, n, hd), m.reshape(B, nh, n),
                 l.reshape(B, nh, n))
