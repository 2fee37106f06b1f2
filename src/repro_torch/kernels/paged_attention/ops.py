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

The kernel splits each page chain across blocks (flash-decoding) and
combines the splits in a second pass. `split_plan` decides the splits here,
from the shapes alone; `ref.paged_attention_split_ref` is the same two-pass
arithmetic in plain torch, for the tests.

`paged_attention.launches` counts wrapper calls that launched the kernel
(CUDA tensors only; one per call, both passes together), so a run can show
that its main path went through the kernel. A call made while a CUDA graph
is being captured launches nothing then: it counts in
`paged_attention.captured` instead, and whoever replays the graph adds its
captured launches to `.launches` per replay (`serve.graph`).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.paged_attention.ref import paged_attention_ref

KERNELS = ("cuda", "reference")
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# about four blocks on each of an H100's 132 SMs (chip_smoke.py phase 5 times
# the main shape's alternatives beside this plan)
TARGET_BLOCKS = 512
MIN_SPLIT_TOKENS = 64      # a split spans at least this many positions


class SplitPlan(NamedTuple):
    """Split s of every chain covers pages ranges[s] = [s * pages_per_split,
    min((s + 1) * pages_per_split, nb))."""
    n_splits: int
    pages_per_split: int
    ranges: Tuple[Tuple[int, int], ...]


@functools.lru_cache(maxsize=256)
def split_plan(B: int, nkv: int, nb: int, bs: int) -> SplitPlan:
    """How the kernel splits each slot's chain of nb pages of bs tokens: a
    function of the shapes alone, never of the pool, the table or the
    positions. Aims at TARGET_BLOCKS blocks of (split, KV head, slot), with
    no split under MIN_SPLIT_TOKENS positions, and covers every page of the
    table exactly once. At the main shape (batch 8, 8 KV heads, 32 pages of
    16) it gives 8 splits of 4 pages: 512 blocks."""
    if min(B, nkv, nb, bs) < 1:
        raise ValueError(f"split_plan needs positive shapes, got B={B} "
                         f"nkv={nkv} nb={nb} bs={bs}")
    want = -(-TARGET_BLOCKS // (B * nkv))
    pps = min(nb, max(-(-nb // want), -(-MIN_SPLIT_TOKENS // bs)))
    n = -(-nb // pps)
    return SplitPlan(n, pps, tuple((s * pps, min((s + 1) * pps, nb))
                                   for s in range(n)))


def _check_cuda_args(q, kpool, vpool, table, pos):
    """Raise ValueError on anything the CUDA kernel does not take. Runs on
    every launch, so each tensor attribute is read once."""
    dev, dt = q.device, q.dtype
    for name, t in (("kpool", kpool), ("vpool", vpool), ("table", table),
                    ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if dt not in DTYPES:
        raise ValueError(f"q dtype {dt} not in {DTYPES}")
    if kpool.dtype != dt or vpool.dtype != dt:
        raise ValueError(f"kpool/vpool dtypes {kpool.dtype}/{vpool.dtype} "
                         f"must equal q's {dt}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"table/pos must be int32, got {table.dtype}/"
                         f"{pos.dtype}")
    qs, ks, ts, ps = q.shape, kpool.shape, table.shape, pos.shape
    if len(qs) != 3 or len(ks) != 4 or len(ts) != 2 or len(ps) != 1:
        raise ValueError("expected q (B,nh,hd), pools (P,bs,nkv,hd), table "
                         "(B,nb), pos (B,)")
    B, nh, hd = qs
    P, bs, nkv, hd_kv = ks
    if vpool.shape != ks:
        raise ValueError(f"vpool {tuple(vpool.shape)} != kpool {tuple(ks)}")
    if hd_kv != hd or hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (pool {hd_kv}) must match and be "
                         f"one of {HEAD_DIMS}")
    if nkv < 1 or nh % nkv:
        raise ValueError(f"n_heads {nh} not a multiple of n_kv_heads {nkv}")
    if ts[0] != B or ps[0] != B:
        raise ValueError(f"table {tuple(ts)} / pos {tuple(ps)} do not match "
                         f"batch {B}")
    if P < 1 or bs < 1 or ts[1] < 1:
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
    plan = split_plan(q.shape[0], kpool.shape[2], table.shape[1],
                      kpool.shape[1])
    out = paged_attention_kernel(q, kpool, vpool, table, pos, scale=scale,
                                 n_splits=plan.n_splits,
                                 pages_per_split=plan.pages_per_split)
    if torch.cuda.is_current_stream_capturing():
        paged_attention.captured += 1
    else:
        paged_attention.launches += 1
    return out


paged_attention.launches = 0
paged_attention.captured = 0
