"""Mamba2 block — SSD (state-space duality) [arXiv:2405.21060], the port of
`repro.models.mamba2`.

Layer structure follows the Mamba2 paper: in_proj -> (z | xBC | dt),
causal conv1d on xBC, SSD, gated RMSNorm(y * silu(z)), out_proj.

Full sequences run the SSD scan kernel-switched, as in the reference: with
``cfg.attention_impl == "pallas"`` the port of the Pallas kernel
(`kernels/ssd_scan`: the CUDA kernel on CUDA tensors, its plain version on
CPU tensors), otherwise `ssd_chunked`, the reference's "xla" route (the
quadratic intra-chunk term in matmul form, a loop over chunks for the
carried state). Decode is a one-step update of the state.

`A_log` and `dt_bias` are float32 whatever the parameter dtype, as in the
reference (`init_mamba2`); the SSM state is float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm

# float32 leaves whatever cfg.param_dtype (the weight bridge reads this)
F32_LEAVES = ("A_log", "dt_bias")


# -------------------------------------------------------------------- SSD core

def ssd_chunked(x, dt, A, B, C, chunk_size: int):
    """Chunked SSD. x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n).

    Recurrence: h_t = exp(dt_t*A) h_{t-1} + dt_t * B_t x_t ;  y_t = C_t . h_t
    Returns (y in x's dtype, final_state (b,h,p,n) f32).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk_size, s)
    if s % q:
        # pad to a chunk multiple: dt=0 padding is exact (decay exp(0)=1,
        # zero state update); extra outputs are sliced off below.
        pad = q - s % q
        padded = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                  for t in (x, dt, B, C)]
        y, state = ssd_chunked(*padded[:2], A, *padded[2:], q)
        return y[:, :s], state
    nc = s // q
    rep = h // g
    f32 = torch.float32
    xdt = x.to(f32) * dt.to(f32)[..., None]  # (b,s,h,p)
    a = dt.to(f32) * A.to(f32)[None, None, :]  # (b,s,h)

    def resh(t):
        return t.reshape(b, nc, q, *t.shape[2:])

    xc, ac = resh(xdt), resh(a)
    Bc = resh(B.repeat_interleave(rep, dim=2).to(f32))  # (b,nc,q,h,n)
    Cc = resh(C.repeat_interleave(rep, dim=2).to(f32))
    acs = torch.cumsum(ac, dim=2)  # (b,nc,q,h)

    # intra-chunk (quadratic, matmul form): L[i,j] = exp(acs_i - acs_j),
    # i >= j; the exponent is masked first, so nothing above the diagonal
    # can overflow
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]  # (b,nc,i,j,h)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                  -math.inf))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * L
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # per-chunk end states: S_c = sum_j exp(acs_last - acs_j) dt_j B_j x_j
    decay_to_end = torch.exp(acs[:, :, -1:, :] - acs)  # (b,nc,q,h)
    S_c = torch.einsum("bcjhn,bcjhp->bchpn", Bc,
                       xc * decay_to_end[..., None])
    chunk_decay = torch.exp(acs[:, :, -1, :])  # (b,nc,h)

    # inter-chunk recurrence: the reference's lax.scan over chunks
    H = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    y_off = []
    for c in range(nc):
        y_off.append(torch.einsum("bihn,bhpn->bihp",
                                  Cc[:, c] * torch.exp(acs[:, c])[..., None],
                                  H))
        H = chunk_decay[:, c, :, None, None] * H + S_c[:, c]
    y = (y_diag + torch.stack(y_off, dim=1)).reshape(b, s, h, p)
    return y.to(x.dtype), H


def ssd_decode_step(state, x, dt, A, B, C):
    """One-token recurrence. state:(b,h,p,n) x:(b,h,p) dt:(b,h) B,C:(b,g,n)."""
    h = x.shape[1]
    rep = h // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1).float()  # (b,h,n)
    Ch = C.repeat_interleave(rep, dim=1).float()
    decay = torch.exp(dt * A[None, :]).float()  # (b,h)
    upd = (dt[..., None] * x)[..., :, None] * Bh[:, :, None, :]  # (b,h,p,n)
    state = decay[:, :, None, None] * state + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(x.dtype), state


# --------------------------------------------------------------------- layer

def conv_dim(cfg):
    s = cfg.ssm
    return s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state


def param_shapes(cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di, nh, cd = s.d_inner(d), s.n_heads(d), conv_dim(cfg)
    return {"in_proj": (d, 2 * di + 2 * s.n_groups * s.d_state + nh),
            "conv_w": (s.d_conv, cd), "conv_b": (cd,), "A_log": (nh,),
            "dt_bias": (nh,), "D": (nh,), "norm_scale": (di,),
            "out_proj": (di, d)}


def init_mamba2(gen, cfg):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    cd = conv_dim(cfg)
    pdt = cfg.parameter_dtype
    dev = gen.device
    # dt bias initialized so softplus(dt_bias) spans [dt_min, dt_max]
    u = torch.rand((nh,), generator=gen, device=dev)
    dt_init = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                        + math.log(s.dt_min))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inv softplus
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * s.n_groups * s.d_state + nh,
                              pdt),
        "conv_w": dense_init(gen, s.d_conv, cd, pdt, scale=1.0 / s.d_conv),
        "conv_b": torch.zeros((cd,), dtype=pdt, device=dev),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)),
        "dt_bias": dt_bias.float(),
        "D": torch.ones((nh,), dtype=pdt, device=dev),
        "norm_scale": torch.zeros((di,), dtype=pdt, device=dev),
        "out_proj": dense_init(gen, di, d, pdt),
    }


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d. xBC:(B,S,cd), w:(width,cd). A sum of
    shifted products, as the reference writes it (F.conv1d would take
    cuDNN's TF32 path for f32 on the card)."""
    width = w.shape[0]
    pad = F.pad(xBC, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + pad[:, i:i + xBC.shape[1], :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def _split_proj(cfg, proj):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    return torch.split(proj, [di, di + 2 * gn, proj.shape[-1] - 2 * di
                              - 2 * gn], dim=-1)


def mamba2_forward(params, cfg, u):
    """u: (B, S, d) -> (y, final_state_dict) full-sequence (train/prefill).
    The cache's conv history is the last d_conv-1 pre-activation conv
    inputs, zero-filled on the left for a sequence shorter than that (the
    reference returns fewer rows there, which its decode step cannot take:
    ROADMAP.md Queue 3)."""
    s = cfg.ssm
    B_, S, d = u.shape
    di = s.d_inner(d)
    nh = s.n_heads(d)
    gn = s.n_groups * s.d_state
    proj = u @ params["in_proj"]
    z, xBC_raw, dt = _split_proj(cfg, proj)
    xBC = _causal_conv(xBC_raw, params["conv_w"], params["conv_b"])
    x, Bm, Cm = torch.split(xBC, [di, gn, gn], dim=-1)
    # views of xBC: the kernel reads them through their strides
    x = x.reshape(B_, S, nh, s.head_dim)
    Bm = Bm.reshape(B_, S, s.n_groups, s.d_state)
    Cm = Cm.reshape(B_, S, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    if cfg.attention_impl == "pallas":
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        y, state = ssd_ops.ssd_scan(x, dt, A, Bm, Cm)
    else:
        y, state = ssd_chunked(x, dt, A, Bm, Cm, s.chunk_size)
    y = y + x * params["D"][None, None, :, None]
    y = y.reshape(B_, S, di)
    y = rms_norm(y * F.silu(z), params["norm_scale"], cfg.norm_eps)
    out = y @ params["out_proj"]
    hist = s.d_conv - 1
    conv = F.pad(xBC_raw, (0, 0, max(hist - S, 0), 0))[:, -hist:, :]
    return out, {"ssm": state, "conv": conv}


def mamba2_decode(params, cfg, u, cache):
    """u: (B, 1, d); cache: {"ssm": (B,h,p,n) f32, "conv": (B, d_conv-1, cd)}.
    Returns (out, new cache); the input cache is not modified."""
    s = cfg.ssm
    B_, _, d = u.shape
    di = s.d_inner(d)
    nh = s.n_heads(d)
    gn = s.n_groups * s.d_state
    z, xBC_raw, dt = _split_proj(cfg, u @ params["in_proj"])
    conv_buf = torch.cat([cache["conv"], xBC_raw], dim=1)  # (B, d_conv, cd)
    xBC = F.silu(torch.einsum("bwc,wc->bc", conv_buf, params["conv_w"])
                 + params["conv_b"])
    x, Bm, Cm = torch.split(xBC, [di, gn, gn], dim=-1)
    x = x.reshape(B_, nh, s.head_dim)
    Bm = Bm.reshape(B_, s.n_groups, s.d_state)
    Cm = Cm.reshape(B_, s.n_groups, s.d_state)
    dtv = F.softplus(dt[:, 0].float() + params["dt_bias"][None, :])
    A = -torch.exp(params["A_log"])
    y, state = ssd_decode_step(cache["ssm"], x, dtv, A, Bm, Cm)
    y = y + x * params["D"][None, :, None]
    y = y.reshape(B_, 1, di)
    y = rms_norm(y * F.silu(z), params["norm_scale"], cfg.norm_eps)
    return y @ params["out_proj"], {"ssm": state, "conv": conv_buf[:, 1:, :]}
