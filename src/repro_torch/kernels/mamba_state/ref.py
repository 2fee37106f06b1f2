"""Plain PyTorch version of the Mamba2 decode state step over the paged
layout's per-slot state: what CPU tensors run, what the kernel switch's
plain side ("xla") runs, and what the hand-written kernel
(csrc/mamba_state.cu) is held against.

It is the paged decode's own three passes as they were: the state scaled by
exp(dt A), the update (dt x) B^T added, then y = C h' over the whole f32
state. A dead row (`live` false) steps with decay 1 and update 0, so its
state keeps its bits; its y is read from that state and is garbage its
caller ignores. Fixed shapes and no host synchronisation, so a CUDA graph
may capture it.
"""
from __future__ import annotations

import torch


def mamba_state_ref(ssm, x, dt, A, B, C, live):
    """ssm: (b, h, p, n) f32, stepped in place where `live` (b,) bool
    holds; x: (b, h, p); dt: (b, h) f32 (after softplus); A: (h,) f32; B,
    C: (b, g, n). Returns y (b, h, p) f32."""
    b, h, p = x.shape
    g, n = B.shape[1], B.shape[2]
    rep = h // g
    on = live[:, None]
    decay = torch.where(on, torch.exp(dt * A[None, :]), 1.0)     # (b, h)
    xdt = torch.where(on[..., None], dt[..., None] * x, 0.0)     # (b,h,p)
    # heads grouped as (g, rep) so B and C broadcast over a group's heads:
    # no per-head copies of them
    h5 = ssm.view(b, g, rep, p, n)
    ssm.mul_(decay[:, :, None, None])
    h5.addcmul_(xdt.view(b, g, rep, p, 1), B.float().view(b, g, 1, 1, n))
    y = torch.einsum("bgrpn,bgn->bgrp", h5, C.float().view(b, g, n))
    return y.reshape(b, h, p)
