"""Plain float32 reference of granite-4.0-h (`granitemoehybrid`), over the
port's parameter layout (`transformer.param_shapes`): the repository's copy
(the benchmark has its own, `portbench/reference/granite_hybrid.py`).

Written from the published layer equations, not from the port's modules:
no kernel, no cache, no batching, one sequence, every product in f32 with
TF32 off (`f32`). Each layer is

    x = x + r * mixer(rmsnorm(x))
    x = x + r * (moe(h) + shared(h)),  h = rmsnorm(x)

with r the residual multiplier; the embedding is multiplied by the
embedding multiplier and the logits divided by `logits_scaling`. RMSNorm
is x * rsqrt(mean(x^2) + eps) * (1 + w), the port's storage of the scale.

* Mamba2 mixer: in_proj -> (z | xBC | dt), a causal depthwise conv of
  width d_conv with bias and SiLU, the SSD recurrence
  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = C_t h_t + D x_t, from
  zero state, computed in its chunked dual form (`ssd_dual`), the gated
  RMSNorm of y * silu(z), out_proj.
* Attention: causal grouped-query attention scaled by the attention
  multiplier (1/sqrt(head_dim) where it is 0), with no positional encoding
  under `nope` (else RoPE in split halves).
* MoE: softmax over the top-k of the router's logits over all
  `n_experts` (lower index first on a tie), SiLU-gated experts, GShard
  capacity C = max(k, round(G k factor / E)) over (token, choice) entries
  in token-major order, G the prompt's length for prompt positions; every
  later position is a group of one, which drops nothing. Only the experts
  held (`held_experts` of them from `first_held`; all where 0) add their
  part; a shared expert runs on every token.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def f32():
    """TF32 off for the reference's products (a card would use it)."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def ssd_dual(x, dt, A, B, C, chunk: int):
    """x (T, h, p), dt (T, h), A (h,), B and C (T, g, n), f32. The SSD
    recurrence from zero state, chunk by chunk: inside a chunk the
    quadratic form y_i = sum_{j<=i} (C_i . B_j) exp(sum_{j<k<=i} dt_k A)
    dt_j x_j, plus the carried state's part exp(sum_{k<=i} dt_k A) C_i h;
    the state then moves to the chunk's end. Returns (y (T, h, p), final
    state (h, p, n))."""
    T, h, p = x.shape
    g, n = B.shape[1], B.shape[2]
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=1)                    # (T, h, n)
    Ch = C.repeat_interleave(rep, dim=1)
    H = torch.zeros((h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for a in range(0, T, chunk):
        b = min(T, a + chunk)
        q = b - a
        la = torch.cumsum(dt[a:b] * A[None, :], dim=0)      # (q, h)
        seg = la[:, None, :] - la[None, :, :]               # (i, j, h)
        causal = torch.ones((q, q), dtype=torch.bool,
                            device=x.device).tril()[:, :, None]
        decay = torch.exp(torch.where(causal, seg, -math.inf))
        cb = torch.einsum("ihn,jhn->ijh", Ch[a:b], Bh[a:b])
        u = dt[a:b, :, None] * x[a:b]                       # (q, h, p)
        y = torch.einsum("ijh,jhp->ihp", cb * decay, u)
        y = y + torch.einsum("ihn,hpn->ihp",
                             Ch[a:b] * torch.exp(la)[:, :, None], H)
        to_end = torch.exp(la[-1][None, :] - la)            # (q, h)
        H = torch.exp(la[-1])[:, None, None] * H + torch.einsum(
            "jhp,jhn->hpn", u * to_end[:, :, None], Bh[a:b])
        ys.append(y)
    return torch.cat(ys), H


def mamba(h, mp, cfg):
    s = cfg.ssm
    d = cfg.d_model
    di, nh, g, n = s.d_inner(d), s.n_heads(d), s.n_groups, s.d_state
    T = h.shape[0]
    z, xbc, dt = torch.split(h @ mp["in_proj"].float(),
                             [di, di + 2 * g * n, nh], dim=-1)
    w = mp["conv_w"].float()
    pad = F.pad(xbc, (0, 0, s.d_conv - 1, 0))
    xbc = F.silu(sum(pad[k:k + T] * w[k] for k in range(s.d_conv))
                 + mp["conv_b"].float())
    x, B, C = torch.split(xbc, [di, g * n, g * n], dim=-1)
    x = x.reshape(T, nh, s.head_dim)
    dt = F.softplus(dt + mp["dt_bias"].float())
    A = -torch.exp(mp["A_log"].float())
    y, _ = ssd_dual(x, dt, A, B.reshape(T, g, n), C.reshape(T, g, n),
                    s.chunk_size)
    y = (y + x * mp["D"].float()[None, :, None]).reshape(T, di)
    y = rms_norm(y * F.silu(z), mp["norm_scale"], cfg.norm_eps)
    return y @ mp["out_proj"].float()


def _rope(x, pos, theta):
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h, ap, cfg):
    T = h.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (h @ ap["wq"].float()).reshape(T, nh, hd)
    k = (h @ ap["wk"].float()).reshape(T, nkv, hd)
    v = (h @ ap["wv"].float()).reshape(T, nkv, hd)
    if not cfg.nope:
        pos = torch.arange(T, device=h.device)
        q, k = _rope(q, pos, cfg.rope_theta), _rope(k, pos, cfg.rope_theta)
    scale = cfg.attention_multiplier or 1.0 / math.sqrt(hd)
    qr = q.reshape(T, nkv, nh // nkv, hd)
    s = torch.einsum("qkrh,skh->krqs", qr, k) * scale
    mask = torch.ones((T, T), dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~mask, -math.inf)
    out = torch.einsum("krqs,skh->qkrh", torch.softmax(s, -1), v)
    return out.reshape(T, nh * hd) @ ap["wo"].float()


def _gated(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate.float()) * (x @ w_up.float())) \
        @ w_down.float()


def moe(h, fp, cfg, prompt_len: int):
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    first, held = m.first_held, m.held_experts or E
    T = h.shape[0]
    logits = h @ fp["router"].float()
    vals, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    idx = order[:, :K]
    gates = torch.softmax(vals[:, :K], dim=-1)
    keep = torch.ones((T, K), dtype=torch.bool, device=h.device)
    P = min(prompt_len, T)
    if P:
        flat = F.one_hot(idx[:P].reshape(-1), E)
        slot = (torch.cumsum(flat, 0) * flat).sum(-1) - 1
        cap = int(max(K, round(P * K * m.capacity_factor / E)))
        keep[:P] = (slot < cap).reshape(P, K)
    out = torch.zeros_like(h)
    for i in range(held):
        t, j = torch.nonzero((idx == first + i) & keep, as_tuple=True)
        if t.numel():
            y = _gated(h[t], fp["w_gate"][i], fp["w_up"][i], fp["w_down"][i])
            out.index_add_(0, t, y * gates[t, j, None])
    if "shared" in fp:
        sp = fp["shared"]
        out = out + _gated(h, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out


@torch.no_grad()
def forward(params, cfg, tokens, prompt_len: int) -> torch.Tensor:
    """f32 logits (T, V) at every position of `tokens` (a prompt of
    `prompt_len` tokens, then the tokens served after it)."""
    with f32():
        tok = torch.as_tensor(tokens, dtype=torch.long,
                              device=params["embed"]["table"].device)
        x = params["embed"]["table"][tok].float() * cfg.embedding_multiplier
        r, eps = cfg.residual_multiplier, cfg.norm_eps
        for lp, t in zip(params["layers"], cfg.layer_types()):
            h = rms_norm(x, lp["norm1"]["scale"], eps)
            x = x + r * (mamba(h, lp["mamba"], cfg) if t == "ssm"
                         else attention(h, lp["attn"], cfg))
            if "ffn" in lp:
                h = rms_norm(x, lp["norm2"]["scale"], eps)
                x = x + r * moe(h, lp["ffn"], cfg, prompt_len)
        x = rms_norm(x, params["final_norm"]["scale"], eps)
        return (x @ params["embed"]["table"].float().T) / cfg.logits_scaling
