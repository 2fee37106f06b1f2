"""The decoder family: pre-norm grouped-query attention layers with RoPE,
each followed by a SiLU-gated dense FFN or a top-k MoE FFN, and a tied or
untied head (granite-moe-3b-a800m, mistral-nemo-12b). The model side of
the harness for such a configuration, as `spec.FAMILY_FUNCTIONS` lists
it.

Weights: one stacked tensor per kind of matrix for all layers (a leading
layer axis). Distributions are the JAX package's initialisers: matrices
uniform in +-1/sqrt(d_in), the MoE router in +-0.02, the embedding
N(0, 0.02^2). Norm scales, which that initialiser sets to zero (a scale
of 1, stored as 1 + w), are drawn uniform in +-0.1 here so that the
comparison also covers them.

Counts are of what the inputs need, not of what the program happens to
compute: a decode position computes the top-k experts of an MoE layer,
attention over the positions written so far, and the logits once."""
from __future__ import annotations

import math
from typing import Dict

from portbench.check import bucket
from portbench.counts import elt_bytes
from portbench.reference import lm

NORM_SCALE = 0.1


def shapes(m: dict) -> Dict[str, tuple]:
    L, d, V = m["n_layers"], m["d_model"], m["vocab_size"]
    nh, nkv = m["n_heads"], m["n_kv_heads"]
    hd = head_dim(m)
    out = {"embed": (V, d), "final_norm": (d,), "norm1": (L, d),
           "norm2": (L, d), "wq": (L, d, nh * hd), "wk": (L, d, nkv * hd),
           "wv": (L, d, nkv * hd), "wo": (L, nh * hd, d)}
    if not m["tie_embeddings"]:
        out["lm_head"] = (d, V)
    moe = m.get("moe")
    if moe:
        E, f = moe["n_experts"], moe["expert_d_ff"]
        out.update(router=(L, d, E), moe_gate=(L, E, d, f),
                   moe_up=(L, E, d, f), moe_down=(L, E, f, d))
    else:
        f = m["d_ff"]
        out.update(w_gate=(L, d, f), w_up=(L, d, f), w_down=(L, f, d))
    return out


def distribution(name: str, shape: tuple) -> tuple:
    if name == "embed":
        return ("normal", 0.02)
    if name == "router":
        s = 0.02
    elif name.startswith("norm") or name == "final_norm":
        s = NORM_SCALE
    else:
        s = 1.0 / math.sqrt(shape[-2])          # +-1/sqrt(d_in)
    return ("uniform", -s, s)


def program_params(w: dict, m: dict, cfg) -> dict:
    """The port's layout (`transformer.param_shapes`): per layer norm1,
    attn, norm2 and ffn, as views of the stacked weights."""
    layers = []
    for l in range(m["n_layers"]):
        if m.get("moe"):
            ffn = {"router": w["router"][l], "w_gate": w["moe_gate"][l],
                   "w_up": w["moe_up"][l], "w_down": w["moe_down"][l]}
        else:
            ffn = {"w_gate": w["w_gate"][l], "w_up": w["w_up"][l],
                   "w_down": w["w_down"][l]}
        layers.append({"norm1": {"scale": w["norm1"][l]},
                       "attn": {n: w[n][l] for n in ("wq", "wk", "wv", "wo")},
                       "norm2": {"scale": w["norm2"][l]}, "ffn": ffn})
    params = {"embed": {"table": w["embed"]}, "layers": layers,
              "final_norm": {"scale": w["final_norm"]}}
    if not m["tie_embeddings"]:
        params["lm_head"] = w["lm_head"]
    return params


def reference_logits(w, m: dict, mix: dict, r, quant=None):
    """`reference.lm` over the prompt and the served tokens; an MoE
    prefill's dispatch group is its prompt's padded length."""
    if m.get("moe") and mix.get("shared"):
        raise ValueError("the MoE reference groups a prefill by its whole "
                         "prompt; a mix that reuses prefixes needs the "
                         "reused length")
    P = len(r.prompt)
    return lm.logits(w, m, r.prompt + r.tokens[:-1], P,
                     bucket(P, mix["cache_len"]), quant=quant)


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def layer_matmul_params(m: dict) -> int:
    """Weights one token multiplies by in one layer: the attention
    projections and the FFN (an MoE's router and its top-k experts)."""
    d, hd = m["d_model"], head_dim(m)
    nh, nkv = m["n_heads"], m["n_kv_heads"]
    attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
    moe = m.get("moe")
    if moe:
        ffn = d * moe["n_experts"] + moe["top_k"] * 3 * d * moe["expert_d_ff"]
    else:
        ffn = 3 * d * m["d_ff"]
    return attn + ffn


def token_flops(m: dict, context: int) -> int:
    """Operations of one token through every layer, attending `context`
    positions (itself included): 2 per multiply-add of the weights, and
    4 * heads * head_dim per attended position (scores and the weighted
    sum). The logits are counted apart (`logits_flops`)."""
    attn = 4 * m["n_heads"] * head_dim(m) * context
    return m["n_layers"] * (2 * layer_matmul_params(m) + attn)


def logits_flops(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab_size"]


def decode_flops(m: dict, positions) -> int:
    """A decode step's operations: one token per position in `positions`
    (the absolute position each token is written at), with its logits."""
    return sum(token_flops(m, p + 1) + logits_flops(m) for p in positions)


def prefill_flops(m: dict, start: int, n: int) -> int:
    """A prefill computing positions start .. start + n - 1 (the reused
    prefix before `start` is not computed), causal, with the logits of
    its last position only (the one the first token needs)."""
    if n <= 0:
        return 0
    L, nh, hd = m["n_layers"], m["n_heads"], head_dim(m)
    # sum of (p + 1) over p in [start, start + n)
    attended = n * start + n * (n + 1) // 2
    return (n * L * 2 * layer_matmul_params(m) + L * 4 * nh * hd * attended
            + logits_flops(m))


def layer_read_bytes(m: dict, position: int, block_size: int) -> int:
    """Bytes one slot's paged-attention read needs in one layer at
    `position`: K and V of positions 0..position once, q read and the
    output written once, the block ids of the pages it reads and its
    position (int32 each)."""
    e, hd = elt_bytes(m), head_dim(m)
    kv = 2 * (position + 1) * m["n_kv_heads"] * hd * e
    qo = 2 * m["n_heads"] * hd * e
    return kv + qo + 4 * (position // block_size + 1) + 4


def paged_read_bytes(m: dict, position: int, block_size: int) -> int:
    """`layer_read_bytes` in every layer: each one is an attention layer."""
    return layer_read_bytes(m, position, block_size) * m["n_layers"]
