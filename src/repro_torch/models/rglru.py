"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), the
port of `repro.models.rglru`.

Recurrence (per channel):
    r_t = sigmoid(W_r x_t + b_r)          # recurrence gate
    i_t = sigmoid(W_i x_t + b_i)          # input gate
    log_a_t = -c * softplus(Lambda) * r_t
    h_t = exp(log_a_t) * h_{t-1} + sqrt(1 - exp(2 log_a_t)) * (i_t * x_t)

Full sequences run the scan kernel-switched, as in the reference: with
``cfg.attention_impl == "pallas"`` and no initial state, the port of the
Pallas kernel (`kernels/rglru_scan`: the CUDA kernel on CUDA tensors, its
plain version on CPU tensors); otherwise a log-depth scan in torch, the
counterpart of the reference's `jax.lax.associative_scan`. Decode is a
one-step update. The block wraps the RG-LRU in the Griffin gated unit: two
linear branches, conv1d(4) + RG-LRU on one, GeLU gate on the other.

The gate biases and Lambda are float32 whatever the parameter dtype, as in
the reference (`init_rglru_block`); the recurrent state `h` is float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ACTIVATIONS, dense_init

# float32 leaves whatever cfg.param_dtype (the weight bridge reads this)
F32_LEAVES = ("b_r", "b_i", "Lambda")


def init_rglru_block(gen, cfg):
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    pdt = cfg.parameter_dtype
    dev = gen.device
    # Lambda init so a^c in [0.9, 0.999] roughly (Griffin appendix)
    u = 0.9 + 0.099 * torch.rand((w,), generator=gen, device=dev)
    lam = torch.log(torch.expm1(-torch.log(u) / cfg.rglru.c_exponent))
    return {
        "w_x": dense_init(gen, d, w, pdt),        # recurrent branch in-proj
        "w_gate_branch": dense_init(gen, d, w, pdt),
        "conv_w": dense_init(gen, cfg.rglru.d_conv, w, pdt,
                             scale=1.0 / cfg.rglru.d_conv),
        "conv_b": torch.zeros((w,), dtype=pdt, device=dev),
        "w_r": dense_init(gen, w, w, pdt),
        "b_r": torch.zeros((w,), dtype=torch.float32, device=dev),
        "w_i": dense_init(gen, w, w, pdt),
        "b_i": torch.zeros((w,), dtype=torch.float32, device=dev),
        "Lambda": lam.float(),
        "out_proj": dense_init(gen, w, d, pdt),
    }


def param_shapes(cfg) -> dict:
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    return {"w_x": (d, w), "w_gate_branch": (d, w),
            "conv_w": (cfg.rglru.d_conv, w), "conv_b": (w,), "w_r": (w, w),
            "b_r": (w,), "w_i": (w, w), "b_i": (w,), "Lambda": (w,),
            "out_proj": (w, d)}


def _gates(params, cfg, x):
    """(a, gated_x), both f32, from x (..., S, w)."""
    r = torch.sigmoid((x @ params["w_r"]).float() + params["b_r"])
    i = torch.sigmoid((x @ params["w_i"]).float() + params["b_i"])
    log_a = -cfg.rglru.c_exponent * F.softplus(params["Lambda"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated_x = beta * (i * x.float())
    return a, gated_x


def _linear_scan(a, b):
    """Inclusive scan of y_t = a_t * y_{t-1} + b_t along dim 1 from y = 0,
    in ceil(log2 S) rounds (Hillis-Steele): round k combines each step with
    the one 2^k before it under (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2),
    the reference's associative-scan operator."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_scan(params, cfg, x, h0=None):
    """x: (B, S, w) -> (y in x's dtype, h_final (B, w) f32). The Pallas
    route (`kernels/rglru_scan`) runs only without an initial state, as in
    the reference; with `h0` the state is folded in as a virtual step 0
    with a = 1."""
    a, gx = _gates(params, cfg, x)                              # (B,S,w) f32
    if cfg.attention_impl == "pallas" and h0 is None:
        from repro_torch.kernels.rglru_scan import ops as rg_ops
        y, h_fin = rg_ops.rglru_scan(a, gx)
        return y.to(x.dtype), h_fin
    if h0 is not None:
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        gx = torch.cat([h0[:, None, :].float(), gx], dim=1)
    Y = _linear_scan(a, gx)
    if h0 is not None:
        Y = Y[:, 1:]
    return Y.to(x.dtype), Y[:, -1].float()


def rglru_step(params, cfg, x, h):
    """x: (B, w); h: (B, w) f32 -> (y, h_new)."""
    a, gx = _gates(params, cfg, x[:, None, :])
    h_new = a[:, 0] * h + gx[:, 0]
    return h_new.to(x.dtype), h_new


def _conv_full(x, w, b):
    """Causal depthwise conv over time: x (B, S, w), w (width, w)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + pad[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out + b[None, None, :]


def rglru_block_forward(params, cfg, x):
    """Griffin recurrent block, full sequence. x: (B, S, d). Returns (out,
    cache {"h": (B, w) f32, "conv": (B, d_conv-1, w)})."""
    gelu = ACTIVATIONS["gelu"]                 # jax.nn.gelu: the tanh form
    branch = x @ params["w_x"]                                  # (B,S,w)
    gate = gelu(x @ params["w_gate_branch"])
    conv_out = _conv_full(branch, params["conv_w"], params["conv_b"])
    y, h_fin = rglru_scan(params, cfg, conv_out)
    out = (y * gate) @ params["out_proj"]
    # the conv window's history: the last d_conv-1 branch rows, zero-
    # filled on the left for a sequence shorter than that (the reference
    # returns fewer rows there, which its decode step cannot take)
    hist = cfg.rglru.d_conv - 1
    cache = {"h": h_fin,
             "conv": F.pad(branch, (0, 0, max(hist - x.shape[1], 0), 0))
             [:, -hist:, :]}
    return out, cache


def rglru_block_decode(params, cfg, x, cache):
    """x: (B, 1, d); cache {"h": (B,w) f32, "conv": (B, d_conv-1, w)}.
    Returns (out, new cache); the input cache is not modified."""
    gelu = ACTIVATIONS["gelu"]
    branch = x @ params["w_x"]                                  # (B,1,w)
    gate = gelu(x @ params["w_gate_branch"])
    buf = torch.cat([cache["conv"], branch], dim=1)             # (B,d_conv,w)
    conv_out = torch.einsum("bwc,wc->bc", buf, params["conv_w"]) \
        + params["conv_b"]
    y, h_new = rglru_step(params, cfg, conv_out, cache["h"])
    out = (y[:, None, :] * gate) @ params["out_proj"]
    return out, {"h": h_new, "conv": buf[:, 1:, :]}
