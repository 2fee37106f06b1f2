"""The yardstick's arithmetic: the chip's peaks and the operations and
bytes a step needs, from a configuration's `model` section (the sizes as
run) and the shapes of the work. Counts are of what the inputs need, not
of what the program happens to compute: a decode position computes the
top-k experts of an MoE layer, attention over the positions written so
far, and the logits once.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity):
989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3; the bound
arithmetic of `chip_smoke.py` (bytes / 3.35 TB/s), copied."""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

_ELT = {"bfloat16": 2, "float16": 2, "float32": 4}


def elt_bytes(m: dict) -> int:
    return _ELT[m.get("dtype", "float32")]


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


def paged_read_bytes(m: dict, position: int, block_size: int) -> int:
    """Bytes one slot's paged-attention read needs in one layer at
    `position`: K and V of positions 0..position once, q read and the
    output written once, the block ids of the pages it reads and its
    position (int32 each)."""
    e, hd = elt_bytes(m), head_dim(m)
    kv = 2 * (position + 1) * m["n_kv_heads"] * hd * e
    qo = 2 * m["n_heads"] * hd * e
    return kv + qo + 4 * (position // block_size + 1) + 4
