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

With a tensor-parallel context (`sharding.tp`, `mamba2_forward(...,
tp=)`, `mamba2_decode(..., tp=)`) the block runs this rank's heads
(`_rank_params`); the gated RMSNorm sums its squares over the model
ranks. A decode step takes and returns the whole state, the reference's
layout (`rank_state`, `whole_state`).

On the paged layout (`transformer.init_paged_cache`) each slot's state is
a row of {"ssm", "conv"} tensors allocated once with the KV pools:
`mamba2_prefill_paged` writes a prompt's final state into its slot's row
and `mamba2_decode_paged` steps the live rows in place (under "pallas" the
hand-written state-step kernel, `kernels/mamba_state`), with no fresh
state tensor, so the fused decode's CUDA graph holds the state's
addresses as it holds the pools'. Device regions (`obs.trace`):
"mamba.proj" (in_proj and the conv), "mamba.scan" (a full sequence's
SSD), "mamba.state" (a decode step's state update) and "mamba.out" (the
skip, the gated norm and out_proj).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_state import ops as ms_ops
from repro_torch.kernels.mamba_state.ref import mamba_state_ref
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.obs import trace as otrace
from repro_torch.sharding import tp as TP

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


def _rank_columns(cfg, tp):
    """Where this rank's heads lie in the block's fused layouts, the one
    map the split forward, the split decode and the state's gather share:
    its first head and head count, the groups its heads read
    (`tp.head_groups`: one entry per local group), and its conv channels
    as segments in local order, [its x | the B of its groups | their C],
    each a range of the whole [x | B | C] with a flag: whether the rank
    gives the segment to the gathered state. Its x always; a group's B or
    C only on the lowest rank whose heads read the group, and there once
    (the other readers hold the same columns)."""
    s = cfg.ssm
    di, nh, n = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), s.d_state
    gn = s.n_groups * n
    nh_l = nh // tp.size
    first = tp.rank * nh_l
    rep = nh // s.n_groups
    groups = TP.head_groups(first, nh_l, rep)
    segs = [((first * s.head_dim, (first + nh_l) * s.head_dim), True)]
    for off in (di, di + gn):
        seen = set()
        for k in groups:
            mine = k * rep // nh_l == tp.rank and k not in seen
            seen.add(k)
            segs.append(((off + k * n, off + (k + 1) * n), mine))
    return {"first": first, "heads": nh_l, "groups": groups,
            "segments": segs}


def _cols(w, ranges):
    return torch.cat([w[..., a:b] for a, b in ranges], dim=-1)


def _rank_params(params, cfg, tp):
    """The leaves as this rank's heads use them, and its group count:
    `in_proj`'s columns of its heads' z, x and dt and of the B/C of the
    groups they read (`_rank_columns`), `conv_w`/`conv_b` on its x, B and
    C channels, its heads' `A_log`, `dt_bias`, `D` and channels of
    `norm_scale`; `out_proj` is already its rows."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    m = _rank_columns(cfg, tp)
    xbc = [r for r, _ in m["segments"]]                  # in [x | B | C]
    dt0 = 2 * di + 2 * gn + m["first"]
    return {"in_proj": _cols(params["in_proj"], [xbc[0]] + [
                (a + di, b + di) for a, b in xbc] + [(dt0, dt0 + m["heads"])]),
            **{k: _cols(params[k], xbc) for k in ("conv_w", "conv_b")},
            **{k: tp.shard(params[k]) for k in ("A_log", "dt_bias", "D",
                                                 "norm_scale")},
            "out_proj": params["out_proj"]}, len(m["groups"])


def rank_state(cfg, state, tp):
    """This rank's part of a whole decode state {"ssm": (B, h, p, n),
    "conv": (B, d_conv-1, cd)}: its heads' states and its conv channels
    (`_rank_columns`)."""
    m = _rank_columns(cfg, tp)
    return {"ssm": state["ssm"].narrow(1, m["first"], m["heads"]),
            "conv": _cols(state["conv"], [r for r, _ in m["segments"]])}


def whole_state(cfg, state, tp):
    """The whole decode state from every rank's part (`rank_state`'s
    layout): each rank writes its heads' states and the conv segments it
    gives (`_rank_columns`) into a zeroed buffer of the whole, in float32,
    and one all-reduce sums them. Every element has one nonzero summand,
    so the sum is exact (the conv window returns to its dtype unchanged).
    The same on every rank; no gradient (serving state)."""
    s = cfg.ssm
    ssm, conv = state["ssm"], state["conv"]
    B_, nh, cd = ssm.shape[0], s.n_heads(cfg.d_model), conv_dim(cfg)
    m = _rank_columns(cfg, tp)
    ssm_shape = (B_, nh) + tuple(ssm.shape[2:])
    conv_shape = (B_, conv.shape[1], cd)
    n_ssm = ssm[0, 0].numel() * nh
    with torch.no_grad():
        packed = ssm.new_zeros((B_, n_ssm + conv_shape[1] * cd))
        packed[:, :n_ssm].view(ssm_shape).narrow(
            1, m["first"], m["heads"]).copy_(ssm)
        full_conv = packed[:, n_ssm:].view(conv_shape)
        at = 0
        for (a, b), mine in m["segments"]:
            if mine:
                full_conv[..., a:b] = conv[..., at:at + b - a]
            at += b - a
        packed = tp.all_reduce(packed)
    return {"ssm": packed[:, :n_ssm].reshape(ssm_shape),
            "conv": packed[:, n_ssm:].reshape(conv_shape).to(conv.dtype)}


def mamba2_forward(params, cfg, u, tp=None):
    """u: (B, S, d) -> (y, final_state_dict) full-sequence (train/prefill).
    The cache's conv history is the last d_conv-1 pre-activation conv
    inputs, zero-filled on the left for a sequence shorter than that (the
    reference returns fewer rows there, which its decode step cannot take:
    ROADMAP.md Queue 3).

    With a tensor-parallel context (`sharding.tp`) params hold this rank's
    rows of `out_proj` and every other leaf gathered: u enters through
    `copy_to_model`, the block runs the rank's heads (`_rank_params`: the
    conv on their channels, the SSD on the heads, the gated RMSNorm over
    the whole d_inner), the cache is the rank's part (`rank_state`'s
    layout; `whole_state` gathers it), and the row-parallel output
    leaves through `reduce_from_model`."""
    s = cfg.ssm
    B_, S, d = u.shape
    di, nh, g = s.d_inner(d), s.n_heads(d), s.n_groups
    if tp is not None:
        u = TP.copy_to_model(u, tp)
        params, g = _rank_params(params, cfg, tp)
        di, nh = di // tp.size, nh // tp.size
    gn = g * s.d_state
    with otrace.region("mamba.proj") as rg:
        proj = u @ params["in_proj"]
        z, xBC_raw, dt = torch.split(proj, [di, di + 2 * gn, nh], dim=-1)
        xBC = _causal_conv(xBC_raw, params["conv_w"], params["conv_b"])
        x, Bm, Cm = torch.split(xBC, [di, gn, gn], dim=-1)
        # views of xBC: the kernel reads them through their strides
        x = x.reshape(B_, S, nh, s.head_dim)
        Bm = Bm.reshape(B_, S, g, s.d_state)
        Cm = Cm.reshape(B_, S, g, s.d_state)
        dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
        A = -torch.exp(params["A_log"])
        rg.switch("mamba.scan")
        if cfg.attention_impl == "pallas":
            from repro_torch.kernels.ssd_scan import ops as ssd_ops
            y, state = ssd_ops.ssd_scan(x, dt, A, Bm, Cm)
        else:
            y, state = ssd_chunked(x, dt, A, Bm, Cm, s.chunk_size)
        rg.switch("mamba.out")
        y = y + x * params["D"][None, None, :, None]
        y = y.reshape(B_, S, di)
        y = rms_norm(y * F.silu(z), params["norm_scale"], cfg.norm_eps, tp)
        out = y @ params["out_proj"]
    if tp is not None:
        out = TP.reduce_from_model(out, tp)
    hist = s.d_conv - 1
    conv = F.pad(xBC_raw, (0, 0, max(hist - S, 0), 0))[:, -hist:, :]
    return out, {"ssm": state, "conv": conv}


def mamba2_decode(params, cfg, u, cache, tp=None):
    """u: (B, 1, d); cache: {"ssm": (B,h,p,n) f32, "conv": (B, d_conv-1, cd)}.
    Returns (out, new cache); the input cache is not modified.

    With a tensor-parallel context (`sharding.tp`) params are laid out as
    for `mamba2_forward(..., tp=)` and the cache is the whole state (its
    layout in `rules.cache_specs`): the rank steps its heads on its part
    of it (`rank_state`), the gated RMSNorm sums its squares over the
    ranks, the output leaves through `reduce_from_model`, and the new
    state is made whole again (`whole_state`: one all-reduce)."""
    s = cfg.ssm
    B_, _, d = u.shape
    di, nh, g = s.d_inner(d), s.n_heads(d), s.n_groups
    if tp is not None:
        params, g = _rank_params(params, cfg, tp)
        di, nh = di // tp.size, nh // tp.size
        cache = rank_state(cfg, cache, tp)
    gn = g * s.d_state
    z, xBC_raw, dt = torch.split(u @ params["in_proj"], [di, di + 2 * gn, nh],
                                 dim=-1)
    conv_buf = torch.cat([cache["conv"], xBC_raw], dim=1)  # (B, d_conv, cd)
    xBC = F.silu(torch.einsum("bwc,wc->bc", conv_buf, params["conv_w"])
                 + params["conv_b"])
    x, Bm, Cm = torch.split(xBC, [di, gn, gn], dim=-1)
    x = x.reshape(B_, nh, s.head_dim)
    Bm = Bm.reshape(B_, g, s.d_state)
    Cm = Cm.reshape(B_, g, s.d_state)
    dtv = F.softplus(dt[:, 0].float() + params["dt_bias"][None, :])
    A = -torch.exp(params["A_log"])
    y, state = ssd_decode_step(cache["ssm"], x, dtv, A, Bm, Cm)
    y = y + x * params["D"][None, :, None]
    y = y.reshape(B_, 1, di)
    y = rms_norm(y * F.silu(z), params["norm_scale"], cfg.norm_eps, tp)
    out = y @ params["out_proj"]
    new = {"ssm": state, "conv": conv_buf[:, 1:, :]}
    if tp is not None:
        out = TP.reduce_from_model(out, tp)
        new = whole_state(cfg, new, tp)
    return out, new


def mamba2_prefill_paged(params, cfg, u, state, slot: int):
    """A whole prompt u (1, S, d) from zero state (`mamba2_forward`): its
    final SSM state and conv window are written into row `slot` of the
    paged layout's state {"ssm": (slots, h, p, n) f32, "conv": (slots,
    d_conv-1, cd)}, overwriting what the slot held. Returns the block's
    output (1, S, d)."""
    out, new = mamba2_forward(params, cfg, u)
    with otrace.region("mamba.scan"):
        state["ssm"][slot].copy_(new["ssm"][0])
        state["conv"][slot].copy_(new["conv"][0])
    return out


def mamba2_decode_paged(params, cfg, u, state, live):
    """One decode token per row, u (B, 1, d), over the paged layout's
    state (row b is slot b's), stepped in place for the rows where `live`
    (B,) bool holds; the other rows' state is left as it is (a dead or
    empty slot's output is garbage its caller ignores). The arithmetic is
    `mamba2_decode`'s: h <- exp(dt A) h + (dt x) B^T, y = C h + D x, the
    gated norm and out_proj. The state step is kernel-switched as the
    prefill's scan is: with ``cfg.attention_impl == "pallas"``
    `kernels/mamba_state` (on CUDA tensors the kernel, one pass over each
    live row's state, which refuses a width it does not take; on CPU
    tensors its plain version), otherwise the plain version,
    `mamba_state_ref`. Returns the block's output (B, 1, d)."""
    s = cfg.ssm
    B_, _, d = u.shape
    di, nh, g, n = s.d_inner(d), s.n_heads(d), s.n_groups, s.d_state
    gn = g * n
    ssm, conv = state["ssm"], state["conv"]
    with otrace.region("mamba.proj") as rg:
        z, xBC_raw, dt = torch.split(u @ params["in_proj"],
                                     [di, di + 2 * gn, nh], dim=-1)
        conv_buf = torch.cat([conv, xBC_raw], dim=1)        # (B, d_conv, cd)
        xBC = F.silu(torch.einsum("bwc,wc->bc", conv_buf, params["conv_w"])
                     + params["conv_b"])
        rg.switch("mamba.state")
        conv.copy_(torch.where(live[:, None, None], conv_buf[:, 1:], conv))
        x, Bm, Cm = torch.split(xBC, [di, gn, gn], dim=-1)
        x = x.reshape(B_, nh, s.head_dim)
        Bm, Cm = Bm.view(B_, g, n), Cm.view(B_, g, n)
        dtv = F.softplus(dt[:, 0].float() + params["dt_bias"][None, :])
        A = -torch.exp(params["A_log"])
        if cfg.attention_impl == "pallas":
            y = ms_ops.mamba_state(ssm, x, dtv, A, Bm, Cm, live)
        else:
            y = mamba_state_ref(ssm, x, dtv, A, Bm, Cm, live)
        rg.switch("mamba.out")
        y = y.to(x.dtype) + x * params["D"][None, :, None]
        y = rms_norm(y.reshape(B_, 1, di) * F.silu(z), params["norm_scale"],
                     cfg.norm_eps)
        return y @ params["out_proj"]
