"""Plain PyTorch version of the Mamba2 SSD scan: the sequential recurrence.

The port of the reference oracle (`kernels/ssd_scan/ref.py::ssd_ref`, a
`lax.scan` over time, no chunking) and the function the hand-written
kernel is held against:

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T ;   y_t = C_t . h_t

per (batch, head) from h = 0, in f32, B and C read from head h's group
h // (heads / groups).
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, A, B, C):
    """x: (b,s,h,p); dt: (b,s,h); A: (h,); B, C: (b,s,g,n).
    Returns (y (b,s,h,p) f32, final state (b,h,p,n) f32)."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    Bh = B.repeat_interleave(rep, dim=2).float()
    Ch = C.repeat_interleave(rep, dim=2).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    state = torch.zeros((b, h, p, B.shape[3]), dtype=torch.float32,
                        device=x.device)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af[None, :])                 # (b,h)
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] \
            * Bh[:, t, :, None, :]                                 # (b,h,p,n)
        state = decay[:, :, None, None] * state + upd
        y[:, t] = torch.einsum("bhpn,bhn->bhp", state, Ch[:, t])
    return y, state
