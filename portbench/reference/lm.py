"""Plain float32 reference of the served decoders, from a configuration's
`model` section and the benchmark's own weights (`portbench.weights`),
layer by layer so that an f32 copy of one layer at a time sits beside the
bf16 weights.

The equations are the JAX package's as the port serves them: pre-norm
decoder layers; RMSNorm computed as x * rsqrt(mean(x^2) + eps) * (1 + w);
RoPE in split halves; causal grouped-query attention with 1/sqrt(head_dim)
scaling; a SiLU-gated FFN; the MoE a token-choice top-k router (top k of
the logits, lower index first on a tie, softmax over the k) with SiLU-gated
experts and GShard capacity: a prefill is one dispatch group of its padded
length G, each expert takes at most C = max(k, round(G * k * factor / E))
of the group's (token, choice) entries in token-major, choice-minor order
and drops the rest; a decode position is a group of one, which drops
nothing. Logits come from the tied embedding or the untied head.

`quant="fp8"` is the control: every matrix product takes its inputs
rounded to float8 e4m3 (weights per output column, activations per row,
each scaled to the format's largest value 448) and the K/V entries too,
and accumulates in f32; all else as above.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
QUERY_BLOCK = 512


def _fp8(a: torch.Tensor, dim: int) -> torch.Tensor:
    scale = a.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (a / scale).to(torch.float8_e4m3fn).float() * scale


class _Precision:
    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant must be None or 'fp8', got {quant!r}")
        self.quant = quant

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """f32 copy of a (.., d_in, d_out) weight; fp8: per output column."""
        w = w.float()
        return _fp8(w, dim=-2) if self.quant else w

    def act(self, a: torch.Tensor) -> torch.Tensor:
        return _fp8(a, dim=-1) if self.quant else a

    def mm(self, a, w_f32):
        return self.act(a) @ w_f32


def capacity(m: dict, group: int) -> int:
    moe = m["moe"]
    k, e = moe["top_k"], moe["n_experts"]
    return int(max(k, round(group * k * moe["capacity_factor"] / e)))


def rms_norm(x, w, eps):
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return x * (1.0 + w.float())


def rope(x, positions, theta):
    """x (T, H, hd); split halves, angles in f32."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = positions.float()[:, None] * inv                   # (T, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v):
    """q (T, nh, hd), k and v (T, nkv, hd) -> (T, nh * hd), f32, in
    blocks of query rows."""
    T, nh, hd = q.shape
    nkv = k.shape[1]
    qr = q.reshape(T, nkv, nh // nkv, hd)
    out = torch.empty((T, nkv, nh // nkv, hd), dtype=torch.float32,
                      device=q.device)
    kpos = torch.arange(T, device=q.device)
    for a in range(0, T, QUERY_BLOCK):
        b = min(T, a + QUERY_BLOCK)
        s = torch.einsum("qkrh,skh->krqs", qr[a:b], k[:b]) / math.sqrt(hd)
        mask = kpos[None, :b] <= torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(~mask, float("-inf"))
        out[a:b] = torch.einsum("krqs,skh->qkrh", torch.softmax(s, -1), v[:b])
    return out.reshape(T, nh * hd)


def _moe(h, m, lw, prec, prompt_len: int, group: int):
    moe = m["moe"]
    E, K = moe["n_experts"], moe["top_k"]
    T = h.shape[0]
    logits = prec.mm(h, prec.weight(lw["router"]))            # (T, E)
    vals, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :K], order[:, :K]
    gates = torch.softmax(vals, dim=-1)
    keep = torch.ones((T, K), dtype=torch.bool, device=h.device)
    P = min(prompt_len, T)
    if P:
        flat = idx[:P].reshape(-1)
        onehot = F.one_hot(flat, E)
        slot = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
        keep[:P] = (slot < capacity(m, group)).reshape(P, K)
    out = torch.zeros_like(h)
    ha = prec.act(h)
    for e in range(E):
        t, j = torch.nonzero((idx == e) & keep, as_tuple=True)
        if t.numel() == 0:
            continue
        x = ha[t]
        g = x @ prec.weight(lw["w_gate"][e])
        u = x @ prec.weight(lw["w_up"][e])
        y = prec.mm(F.silu(g) * u, prec.weight(lw["w_down"][e]))
        out.index_add_(0, t, y * gates[t, j, None])
    return out


def _dense_ffn(h, lw, prec):
    ha = prec.act(h)
    g = ha @ prec.weight(lw["w_gate"])
    u = ha @ prec.weight(lw["w_up"])
    return prec.mm(F.silu(g) * u, prec.weight(lw["w_down"]))


def layer_weights(w: dict, m: dict, l: int) -> dict:
    """Layer l's weights out of the benchmark's stacked tensors."""
    names = ["norm1", "norm2", "wq", "wk", "wv", "wo"]
    names += (["router", "moe_gate", "moe_up", "moe_down"] if m.get("moe")
              else ["w_gate", "w_up", "w_down"])
    lw = {n: w[n][l] for n in names}
    if m.get("moe"):
        lw["w_gate"], lw["w_up"], lw["w_down"] = (
            lw.pop("moe_gate"), lw.pop("moe_up"), lw.pop("moe_down"))
    return lw


@torch.no_grad()
def logits(w: dict, m: dict, tokens, prompt_len: int, group: int,
           quant: Optional[str] = None) -> torch.Tensor:
    """f32 logits (T - prompt_len + 1, V) at positions prompt_len - 1 ..
    T - 1 of `tokens` (a prompt of `prompt_len` tokens and the tokens
    served after it): row j scores the token served at step j. `group`
    is the prompt's padded dispatch length (the MoE's capacity)."""
    prec = _Precision(quant)
    dev = w["embed"].device
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    T = tok.numel()
    d, nh, nkv = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // nh
    eps, theta = m["norm_eps"], m["rope_theta"]
    pos = torch.arange(T, device=dev)
    table = w["embed"]
    x = (_fp8(table[tok].float(), -1) if quant else table[tok].float())
    for l in range(m["n_layers"]):
        lw = layer_weights(w, m, l)
        h = rms_norm(x, lw["norm1"], eps)
        ha = prec.act(h)
        q = (ha @ prec.weight(lw["wq"])).reshape(T, nh, hd)
        k = (ha @ prec.weight(lw["wk"])).reshape(T, nkv, hd)
        v = (ha @ prec.weight(lw["wv"])).reshape(T, nkv, hd)
        q, k = rope(q, pos, theta), rope(k, pos, theta)
        if quant:
            k, v = _fp8(k, -1), _fp8(v, -1)
        a = causal_attention(q, k, v)
        x = x + prec.mm(a, prec.weight(lw["wo"]))
        h = rms_norm(x, lw["norm2"], eps)
        x = x + (_moe(h, m, lw, prec, prompt_len, group) if m.get("moe")
                 else _dense_ffn(h, lw, prec))
        del lw
    x = rms_norm(x[prompt_len - 1:], w["final_norm"], eps)
    head = prec.weight(w["embed"].T if m["tie_embeddings"] else w["lm_head"])
    return torch.cat([prec.mm(x[a:a + QUERY_BLOCK], head)
                      for a in range(0, x.shape[0], QUERY_BLOCK)])
