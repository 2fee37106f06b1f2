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


def ssd_chunk_passes_ref(x, dt, A, B, C, chunk):
    """The tensor-core route's three passes (csrc/ssd_scan.cu) in plain
    PyTorch, the same function as `ssd_ref` by another order of sums:

    1. per chunk, acs = cumsum(dt A) and the end state from 0,
       S_c = (x dt exp(acs_last - acs))^T B;
    2. in chunk order, S_in[c + 1] = exp(acs_last[c]) S_in[c] + S_c[c], the
       last value the final state;
    3. y_i = exp(acs_i) C_i . S_in + sum_{j <= i} (C_i . B_j)
       exp(acs_i - acs_j) dt_j x_j inside the chunk.

    A ragged last chunk is padded with dt = 0 (and x, B, C = 0). For bf16 x
    the operands are rounded to bf16 where the kernel rounds them (the
    scaled x of pass 1, S_in, and the decayed scores of pass 3), with every
    product accumulated in f32. Returns (y (b,s,h,p) in x's dtype, final
    state (b,h,p,n) f32)."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if x.dtype == torch.bfloat16:
        def rnd(t):
            return t.to(torch.bfloat16).float()
    else:
        def rnd(t):
            return t

    def chunks(t):        # (b, s, ...) -> (b, nc, chunk, ...) f32, 0-padded
        t = t.float()
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc, dtc = chunks(x), chunks(dt)                      # (b,nc,q,h,p|)
    Bc = chunks(B.repeat_interleave(rep, dim=2))         # (b,nc,q,h,n)
    Cc = chunks(C.repeat_interleave(rep, dim=2))
    acs = torch.cumsum(dtc * A.float(), dim=2)           # (b,nc,q,h)
    last = acs[:, :, -1]                                 # (b,nc,h)

    # pass 1: the chunks' end states from 0
    w = dtc * torch.exp(last[:, :, None] - acs)
    S_c = torch.einsum("bcjhp,bcjhn->bchpn", rnd(xc * w[..., None]), Bc)

    # pass 2: the state entering each chunk, in chunk order
    state = torch.zeros_like(S_c[:, 0])
    S_in = []
    for c in range(nc):
        S_in.append(state)
        state = torch.exp(last[:, c])[..., None, None] * state + S_c[:, c]
    S_in = rnd(torch.stack(S_in, dim=1))                 # (b,nc,h,p,n)

    # pass 3: the carried term, then the causal intra-chunk term; the
    # exponent is masked first, so nothing above the diagonal can overflow
    y = torch.exp(acs)[..., None] * torch.einsum("bcihn,bchpn->bcihp", Cc,
                                                 S_in)
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]  # (b,nc,i,j,h)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                      -torch.inf))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc)
    P = rnd(scores * (decay * dtc[:, :, None, :, :]))
    y = y + torch.einsum("bcijh,bcjhp->bcihp", P, xc)
    y = y.reshape(b, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), state
