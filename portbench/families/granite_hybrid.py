"""The granite-4.0-h family (`granitemoehybrid`): Mamba2 layers and NoPE
grouped-query attention layers in one stack, every layer ending in a
top-k MoE FFN plus a shared expert, Granite's four multipliers, a tied
head; the layer holds a share of the experts where the configuration
says so (`held_experts`). The model side of the harness for such a
configuration, as `spec.FAMILY_FUNCTIONS` lists it, and the counts that
the readers of its own metrics use.

Weights: one stacked tensor per kind, over the layers that have it (the
Mamba2 leaves over the Mamba2 layers, the attention matrices over the
attention layers, the FFN over all). Matrices are uniform in
+-1/sqrt(d_in), the router in +-0.02, the embedding N(0, EMBED_STD^2)
with EMBED_STD 0.001, not the decoder's 0.02: under the embedding
multiplier 12 and the tied head, a token's own embedding would lead its
logits by some 18 standard deviations of the others at 0.02, so greedy
decoding would repeat the last prompt token by a margin no rounding can
close, and the comparison could not tell a float8 program from a sound
one; at 0.001 that lead is about one standard deviation. Norm
scales (stored as 1 + w) and the conv bias uniform in +-0.1; `D` in [0.5,
1.5]; `A_log` in [0, log 16], so A = -exp(A_log) lies in [-16, -1] as
Mamba2 draws it; `dt_bias` in [-6.875, -2.3], so softplus(dt_bias) lies in
[0.001, 0.1] with room for the bf16 rounding. Every tensor is drawn in
the served dtype; the program takes `A_log` and `dt_bias` in f32, the
same values.

Counts are of what the inputs need, not of what the program happens to
compute: a token multiplies by its Mamba2 projections and conv, runs the
SSD recurrence (4 operations per head, head channel and state entry: the
state's update and the output's read), attends the positions written in
each attention layer, and runs the shared expert and, of its top-k
routed experts, the share this device holds (k x held / E on average).
"""
from __future__ import annotations

import math
from typing import Dict, List

from portbench.counts import elt_bytes
from portbench.reference import granite_hybrid as ref

EMBED_STD = 0.001
NORM_SCALE = 0.1
CONV_BIAS = 0.1
A_LOG = (0.0, math.log(16.0))
DT_BIAS = (-6.875, -2.3)
D_SKIP = (0.5, 1.5)
F32 = 4


def layer_types(m: dict) -> List[str]:
    return ref.layer_types(m)


def _widths(m: dict) -> dict:
    s = m["ssm"]
    d = m["d_model"]
    di = s["expand"] * d
    gn = s["n_groups"] * s["d_state"]
    return {"d": d, "di": di, "gn": gn, "nh": di // s["head_dim"],
            "p": s["head_dim"], "n": s["d_state"], "cd": di + 2 * gn,
            "k": s["d_conv"], "hd": m.get("head_dim")
            or d // m["n_heads"]}


def _held(m: dict) -> int:
    return m["moe"].get("held_experts") or m["moe"]["n_experts"]


def shapes(m: dict) -> Dict[str, tuple]:
    types = layer_types(m)
    L, Lm, La = len(types), types.count("ssm"), types.count("attn")
    w = _widths(m)
    d, di, nh, cd = w["d"], w["di"], w["nh"], w["cd"]
    nq, nkv = m["n_heads"] * w["hd"], m["n_kv_heads"] * w["hd"]
    moe = m["moe"]
    E, H, f, fs = moe["n_experts"], _held(m), moe["expert_d_ff"], \
        moe["shared_d_ff"]
    return {"embed": (m["vocab_size"], d), "final_norm": (d,),
            "norm1": (L, d), "norm2": (L, d),
            "in_proj": (Lm, d, 2 * di + 2 * w["gn"] + nh),
            "conv_w": (Lm, w["k"], cd), "conv_b": (Lm, cd),
            "A_log": (Lm, nh), "dt_bias": (Lm, nh), "D": (Lm, nh),
            "mamba_norm": (Lm, di), "out_proj": (Lm, di, d),
            "wq": (La, d, nq), "wk": (La, d, nkv), "wv": (La, d, nkv),
            "wo": (La, nq, d),
            "router": (L, d, E), "moe_gate": (L, H, d, f),
            "moe_up": (L, H, d, f), "moe_down": (L, H, f, d),
            "shared_gate": (L, d, fs), "shared_up": (L, d, fs),
            "shared_down": (L, fs, d)}


def distribution(name: str, shape: tuple) -> tuple:
    fixed = {"A_log": A_LOG, "dt_bias": DT_BIAS, "D": D_SKIP}
    if name in fixed:
        return ("uniform",) + fixed[name]
    if name == "embed":
        return ("normal", EMBED_STD)
    if name == "router":
        s = 0.02
    elif name in ("norm1", "norm2", "final_norm", "mamba_norm"):
        s = NORM_SCALE
    elif name == "conv_b":
        s = CONV_BIAS
    else:
        s = 1.0 / math.sqrt(shape[-2])          # +-1/sqrt(d_in)
    return ("uniform", -s, s)


def program_params(w: dict, m: dict, cfg) -> dict:
    """The program's layout (`transformer.param_shapes`): per layer norm1,
    its mixer ("mamba" or "attn"), norm2 and the MoE FFN with its shared
    expert, as views of the stacked weights (`A_log` and `dt_bias` as f32
    copies)."""
    layers, at = [], {"ssm": 0, "attn": 0}
    for l, t in enumerate(layer_types(m)):
        i = at[t]
        at[t] += 1
        if t == "ssm":
            mixer = {"mamba": {
                "in_proj": w["in_proj"][i], "conv_w": w["conv_w"][i],
                "conv_b": w["conv_b"][i], "A_log": w["A_log"][i].float(),
                "dt_bias": w["dt_bias"][i].float(), "D": w["D"][i],
                "norm_scale": w["mamba_norm"][i],
                "out_proj": w["out_proj"][i]}}
        else:
            mixer = {"attn": {n: w[n][i] for n in ref.ATTENTION}}
        ffn = {"router": w["router"][l], "w_gate": w["moe_gate"][l],
               "w_up": w["moe_up"][l], "w_down": w["moe_down"][l],
               "shared": {"w_gate": w["shared_gate"][l],
                          "w_up": w["shared_up"][l],
                          "w_down": w["shared_down"][l]}}
        layers.append({"norm1": {"scale": w["norm1"][l]}, **mixer,
                       "norm2": {"scale": w["norm2"][l]}, "ffn": ffn})
    return {"embed": {"table": w["embed"]}, "layers": layers,
            "final_norm": {"scale": w["final_norm"]}}


def reference_logits(w, m: dict, mix: dict, r, quant=None):
    """`reference.granite_hybrid` over the prompt and the served tokens; a
    prompt is prefilled whole (no prefix reuse for a recurrent model), so
    its MoE dispatch group is its exact length."""
    if mix.get("shared"):
        raise ValueError("a recurrent model reuses no prefix; a mix with "
                         "shared documents has no meaning here")
    return ref.logits(w, m, r.prompt + r.tokens[:-1], len(r.prompt),
                      quant=quant)


# ------------------------------------------------------------------ counts

def mamba_matmul_params(m: dict) -> int:
    """in_proj and out_proj of one Mamba2 layer."""
    w = _widths(m)
    return w["d"] * (2 * w["di"] + 2 * w["gn"] + w["nh"]) + w["di"] * w["d"]


def attn_matmul_params(m: dict) -> int:
    w = _widths(m)
    nq, nkv = m["n_heads"] * w["hd"], m["n_kv_heads"] * w["hd"]
    return 2 * w["d"] * nq + 2 * w["d"] * nkv


def ffn_matmul_params(m: dict) -> float:
    """Weights one token multiplies by in one FFN here: the router, its
    expected share of its top-k experts (k x held / E) and the shared
    expert."""
    moe, d = m["moe"], m["d_model"]
    picks = moe["top_k"] * _held(m) / moe["n_experts"]
    return d * moe["n_experts"] + picks * 3 * d * moe["expert_d_ff"] \
        + 3 * d * moe["shared_d_ff"]


def ssd_token_flops(m: dict) -> int:
    """The SSD recurrence for one token in one Mamba2 layer: h <- a h +
    (dt x) B^T and y = C h, a multiply-add per head channel and state
    entry each."""
    w = _widths(m)
    return 4 * w["nh"] * w["p"] * w["n"]


def _mamba_token_flops(m: dict) -> int:
    w = _widths(m)
    return 2 * mamba_matmul_params(m) + 2 * w["k"] * w["cd"] \
        + ssd_token_flops(m)


def token_flops(m: dict) -> float:
    """Operations of one token through every layer, without attention's
    reads of the context and without the logits."""
    types = layer_types(m)
    return types.count("ssm") * _mamba_token_flops(m) \
        + types.count("attn") * 2 * attn_matmul_params(m) \
        + len(types) * 2 * ffn_matmul_params(m)


def _attend_flops(m: dict) -> int:
    """Attention's operations per attended position in every attention
    layer: scores and the weighted sum."""
    return layer_types(m).count("attn") * 4 * m["n_heads"] * _widths(m)["hd"]


def logits_flops(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab_size"]


def decode_flops(m: dict, positions) -> float:
    """A decode step's operations: one token per position in `positions`
    (the absolute position each is written at), with its logits."""
    return sum(token_flops(m) + _attend_flops(m) * (p + 1) + logits_flops(m)
               for p in positions)


def prefill_flops(m: dict, start: int, n: int) -> float:
    """A prefill of positions start .. start + n - 1, causal, with the
    logits of its last position only."""
    if n <= 0:
        return 0
    attended = n * start + n * (n + 1) // 2
    return n * token_flops(m) + _attend_flops(m) * attended + logits_flops(m)


def layer_read_bytes(m: dict, position: int, block_size: int) -> int:
    """Bytes one slot's paged-attention read needs in one attention layer
    at `position`: K and V of positions 0..position once, q read and the
    output written once, the block ids of its pages and its position."""
    e, hd = elt_bytes(m), _widths(m)["hd"]
    kv = 2 * (position + 1) * m["n_kv_heads"] * hd * e
    qo = 2 * m["n_heads"] * hd * e
    return kv + qo + 4 * (position // block_size + 1) + 4


def paged_read_bytes(m: dict, position: int, block_size: int) -> int:
    """`layer_read_bytes` in each of the stack's attention layers."""
    return layer_read_bytes(m, position, block_size) \
        * layer_types(m).count("attn")


def state_bytes_per_slot(m: dict) -> int:
    """A slot's f32 SSM state over the Mamba2 layers."""
    w = _widths(m)
    return layer_types(m).count("ssm") * w["nh"] * w["p"] * w["n"] * F32


def state_step_bytes(m: dict) -> int:
    """Bytes one live slot's decode state updates need over the Mamba2
    layers: its SSM state and conv window read once and written once, and
    its x, B, C and dt read once."""
    w, e = _widths(m), elt_bytes(m)
    ssm = w["nh"] * w["p"] * w["n"] * F32
    conv = (w["k"] - 1) * w["cd"] * e
    inputs = (w["di"] + 2 * w["gn"] + w["nh"]) * e
    return layer_types(m).count("ssm") * (2 * ssm + 2 * conv + inputs)


def ssd_scan_flops(m: dict, n: int) -> int:
    """The SSD scans of one n-token prefill, every Mamba2 layer."""
    return layer_types(m).count("ssm") * n * ssd_token_flops(m)


def ssd_scan_bytes(m: dict, n: int) -> int:
    """Bytes the SSD scans of one n-token prefill need, every Mamba2
    layer: x, B and C read and y written in the served dtype, dt (f32)
    read, A read and the final state (f32) written."""
    w, e = _widths(m), elt_bytes(m)
    per = n * (2 * w["di"] + 2 * w["gn"]) * e + n * w["nh"] * F32 \
        + w["nh"] * F32 + w["nh"] * w["p"] * w["n"] * F32
    return layer_types(m).count("ssm") * per
