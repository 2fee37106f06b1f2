"""Plain PyTorch version of the RG-LRU scan: the sequential recurrence.

The port of the reference oracle (`kernels/rglru_scan/ref.py::rglru_ref`,
a `lax.scan` over time) and the function the hand-written kernel is held
against: y_t = a_t * y_{t-1} + b_t per channel from h = 0, in f32, the
product and the sum rounded separately.
"""
from __future__ import annotations

import torch


def rglru_ref(a, b):
    """a, b: (B, S, C) -> y (B, S, C) f32; y_t = a_t*y_{t-1} + b_t."""
    a32, b32 = a.float(), b.float()
    y = torch.empty_like(a32)
    h = torch.zeros_like(a32[:, 0])
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        y[:, t] = h
    return y


def rglru_chunked_ref(a, b, chunk):
    """The kernel's chunked scan (csrc/rglru_scan.cu) in plain PyTorch: the
    same recurrence in tiles of `chunk` time steps (the last may be short).
    Each tile's aggregate is (prod a, its end value from h = 0); the carry
    into tile c is the aggregates of tiles 0 .. c-1 folded in chunk order,
    and the tile is then scanned from its carry. Every product and sum is
    rounded on its own, as in `rglru_ref`. a, b: (B, S, C) -> y (B, S, C)
    f32."""
    a32, b32 = a.float(), b.float()
    S = a.shape[1]
    starts = range(0, S, chunk)
    aggs = []
    for t0 in starts:
        prod = torch.ones_like(a32[:, 0])
        h = torch.zeros_like(a32[:, 0])
        for t in range(t0, min(t0 + chunk, S)):
            prod = prod * a32[:, t]
            h = a32[:, t] * h + b32[:, t]
        aggs.append((prod, h))
    y = torch.empty_like(a32)
    for c, t0 in enumerate(starts):
        h = torch.zeros_like(a32[:, 0])
        for prod, end in aggs[:c]:
            h = prod * h + end
        for t in range(t0, min(t0 + chunk, S)):
            h = a32[:, t] * h + b32[:, t]
            y[:, t] = h
    return y
