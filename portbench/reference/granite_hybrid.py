"""Plain float32 reference of granite-4.0-h (`granitemoehybrid`), from a
configuration's `model` section and the benchmark's own weights
(`families/granite_hybrid.py`'s stacked tensors), layer by layer so that
an f32 copy of one layer at a time sits beside the bf16 weights. No kernel
of the program, no cache, no batching; TF32 is off (`check.readings`).

The equations, from the published description: the embedding times the
embedding multiplier; each of the layers (Mamba2 or attention, as the
`block_pattern` lays them out) is

    x = x + r * mixer(rmsnorm(x)),
    x = x + r * (moe(h) + shared(h)),  h = rmsnorm(x),

r the residual multiplier; the final norm, and the tied embedding's logits
divided by `logits_scaling`. RMSNorm is x * rsqrt(mean(x^2) + eps) * (1 +
w), the program's storage of the scale.

* Mamba2: in_proj -> (z | xBC | dt); a causal depthwise conv of width
  d_conv with bias, then SiLU; dt = softplus(dt + dt_bias), A =
  -exp(A_log); the SSD h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t =
  C_t h_t + D x_t, from zero state, in its chunked dual form at the
  configuration's chunk (`ssd`); the gated RMSNorm of y * silu(z);
  out_proj.
* Attention: causal grouped-query attention with no positional encoding
  under `nope`, scaled by the attention multiplier.
* MoE: the top k of the router's logits over all `n_experts` (lower index
  first on a tie), softmax over the k, SiLU-gated experts; GShard
  capacity C = max(k, round(G k factor / E)) over (token, choice) entries
  in token-major order, G the prompt's exact length for its positions
  (a recurrent model's prompt is not padded); each later position is a
  group of one, which drops nothing. Only the `held_experts` experts from
  `first_held` add their part, as on the chip that holds them; the shared
  expert runs on every token.

`quant="fp8"` is the control: every matrix product takes its inputs
rounded to float8 e4m3 (`lm._Precision`), and the K/V entries too; the
SSD, its state and everything else stay in f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from portbench.reference.lm import QUERY_BLOCK, _fp8, _Precision, rms_norm


def layer_types(m: dict):
    """The stack's mixers in order: the block pattern repeated, then the
    tail."""
    pat = list(m.get("block_pattern", ["attn"]))
    tail = list(m.get("tail_pattern", []))
    return pat * ((m["n_layers"] - len(tail)) // len(pat)) + tail


def ssd(x, dt, A, B, C, chunk: int):
    """x (T, h, p), dt (T, h), A (h,), B and C (T, g, n), f32: the SSD
    recurrence from zero state, chunk by chunk. Inside a chunk y_i =
    sum_{j<=i} (C_i . B_j) exp(sum_{j<k<=i} dt_k A) dt_j x_j plus the
    carried state's part exp(sum_{k<=i} dt_k A) C_i h; then h moves to the
    chunk's end. Returns y (T, h, p)."""
    T, h, p = x.shape
    rep = h // B.shape[1]
    B = B.repeat_interleave(rep, dim=1)
    C = C.repeat_interleave(rep, dim=1)
    state = torch.zeros((h, p, B.shape[2]), dtype=torch.float32,
                        device=x.device)
    out = torch.empty_like(x)
    for a in range(0, T, chunk):
        b = min(T, a + chunk)
        cum = torch.cumsum(dt[a:b] * A, dim=0)                    # (q, h)
        lower = torch.ones((b - a, b - a), dtype=torch.bool,
                           device=x.device).tril()[:, :, None]
        w = torch.exp(torch.where(lower, cum[:, None] - cum[None], -math.inf))
        w = w * torch.einsum("ihn,jhn->ijh", C[a:b], B[a:b])
        u = dt[a:b, :, None] * x[a:b]
        out[a:b] = torch.einsum("ijh,jhp->ihp", w, u) + torch.einsum(
            "ihn,hpn->ihp", C[a:b] * torch.exp(cum)[:, :, None], state)
        rest = torch.exp(cum[-1] - cum)[:, :, None]
        state = torch.exp(cum[-1])[:, None, None] * state + torch.einsum(
            "jhp,jhn->hpn", u * rest, B[a:b])
    return out


def _mamba(h, m: dict, lw: dict, prec):
    s = m["ssm"]
    d, n, g = m["d_model"], s["d_state"], s["n_groups"]
    di = s["expand"] * d
    nh = di // s["head_dim"]
    T = h.shape[0]
    z, xbc, dt = torch.split(prec.mm(h, prec.weight(lw["in_proj"])),
                             [di, di + 2 * g * n, nh], dim=-1)
    w = lw["conv_w"].float()
    k = s["d_conv"]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    xbc = F.silu(sum(pad[i:i + T] * w[i] for i in range(k))
                 + lw["conv_b"].float())
    x, B, C = torch.split(xbc, [di, g * n, g * n], dim=-1)
    x = x.reshape(T, nh, s["head_dim"])
    dt = F.softplus(dt + lw["dt_bias"].float())
    y = ssd(x, dt, -torch.exp(lw["A_log"].float()), B.reshape(T, g, n),
            C.reshape(T, g, n), s["chunk_size"])
    y = (y + x * lw["D"].float()[None, :, None]).reshape(T, di)
    y = rms_norm(y * F.silu(z), lw["mamba_norm"], m["norm_eps"])
    return prec.mm(y, prec.weight(lw["out_proj"]))


def _attention(h, m: dict, lw: dict, prec):
    T = h.shape[0]
    nh, nkv = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // nh
    ha = prec.act(h)
    q = (ha @ prec.weight(lw["wq"])).reshape(T, nkv, nh // nkv, hd)
    k = (ha @ prec.weight(lw["wk"])).reshape(T, nkv, hd)
    v = (ha @ prec.weight(lw["wv"])).reshape(T, nkv, hd)
    if not m.get("nope"):
        raise ValueError("this reference serves NoPE attention only")
    if prec.quant:
        k, v = _fp8(k, -1), _fp8(v, -1)
    scale = m.get("attention_multiplier") or 1.0 / math.sqrt(hd)
    out = torch.empty((T, nkv, nh // nkv, hd), dtype=torch.float32,
                      device=h.device)
    kpos = torch.arange(T, device=h.device)
    for a in range(0, T, QUERY_BLOCK):
        b = min(T, a + QUERY_BLOCK)
        s = torch.einsum("qkrh,skh->krqs", q[a:b], k[:b]) * scale
        mask = kpos[None, :b] <= torch.arange(a, b, device=h.device)[:, None]
        s = s.masked_fill(~mask, float("-inf"))
        out[a:b] = torch.einsum("krqs,skh->qkrh", torch.softmax(s, -1), v[:b])
    return prec.mm(out.reshape(T, nh * hd), prec.weight(lw["wo"]))


def _gated(x, gate, up, down, prec):
    xa = prec.act(x)
    y = F.silu(xa @ prec.weight(gate)) * (xa @ prec.weight(up))
    return prec.mm(y, prec.weight(down))


def _moe(h, m: dict, lw: dict, prec, prompt_len: int):
    moe = m["moe"]
    E, K = moe["n_experts"], moe["top_k"]
    first, held = moe.get("first_held", 0), moe.get("held_experts") or E
    T = h.shape[0]
    logits = prec.mm(h, prec.weight(lw["router"]))
    vals, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    idx, gates = order[:, :K], torch.softmax(vals[:, :K], dim=-1)
    keep = torch.ones((T, K), dtype=torch.bool, device=h.device)
    P = min(prompt_len, T)
    if P:
        onehot = F.one_hot(idx[:P].reshape(-1), E)
        slot = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
        cap = int(max(K, round(P * K * moe["capacity_factor"] / E)))
        keep[:P] = (slot < cap).reshape(P, K)
    out = _gated(h, lw["shared_gate"], lw["shared_up"], lw["shared_down"],
                 prec)
    for i in range(held):
        t, j = torch.nonzero((idx == first + i) & keep, as_tuple=True)
        if t.numel():
            y = _gated(h[t], lw["moe_gate"][i], lw["moe_up"][i],
                       lw["moe_down"][i], prec)
            out.index_add_(0, t, y * gates[t, j, None])
    return out


MAMBA = ("in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D",
         "mamba_norm", "out_proj")
ATTENTION = ("wq", "wk", "wv", "wo")
FFN = ("norm2", "router", "moe_gate", "moe_up", "moe_down", "shared_gate",
       "shared_up", "shared_down")


@torch.no_grad()
def logits(w: dict, m: dict, tokens, prompt_len: int,
           quant: Optional[str] = None) -> torch.Tensor:
    """f32 logits (T - prompt_len + 1, V) at positions prompt_len - 1 ..
    T - 1 of `tokens` (a prompt of `prompt_len` tokens and the tokens
    served after it): row j scores the token served at step j."""
    prec = _Precision(quant)
    dev = w["embed"].device
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    x = w["embed"][tok].float()
    if quant:
        x = _fp8(x, -1)
    x = x * m.get("embedding_multiplier", 1.0)
    r, eps = m.get("residual_multiplier", 1.0), m["norm_eps"]
    at = {"ssm": 0, "attn": 0}
    for l, t in enumerate(layer_types(m)):
        i = at[t]
        at[t] += 1
        lw = {n: w[n][i] for n in (MAMBA if t == "ssm" else ATTENTION)}
        lw.update({n: w[n][l] for n in FFN})
        h = rms_norm(x, w["norm1"][l], eps)
        x = x + r * (_mamba(h, m, lw, prec) if t == "ssm"
                     else _attention(h, m, lw, prec))
        h = rms_norm(x, lw["norm2"], eps)
        x = x + r * _moe(h, m, lw, prec, prompt_len)
        del lw
    x = rms_norm(x[prompt_len - 1:], w["final_norm"], eps)
    head = prec.weight(w["embed"].T)
    scale = m.get("logits_scaling", 1.0)
    return torch.cat([prec.mm(x[a:a + QUERY_BLOCK], head) / scale
                      for a in range(0, x.shape[0], QUERY_BLOCK)])
