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
