"""Attention-only decoder LM over a paged KV cache — the serving half of
`repro.models.transformer` for pure-attention archs.

The reference stacks block parameters on a leading n_blocks axis and runs
them with `lax.scan`. The port keeps one parameter dict per layer and runs
a Python loop over layers; `params.params_from_jax` unstacks the
reference's tree into this layout.

Entry points:
    init_lm(gen, cfg)                                     -> params
    init_paged_cache(cfg, n_pool_blocks, block_size, device) -> cache
    decode_step_paged(params, cfg, tokens, pos, cache, table) -> (logits, cache)
    forward_prefill_paged(params, cfg, tokens, start, n_tok, cache, table)
                                                          -> (logits, cache)
    copy_pool_blocks(cache, src_ids, dst_ids)             -> cache

Params: {"embed": {"table"}, "layers": [per-layer dict], "final_norm":
{"scale"}, and "lm_head" when embeddings are untied}. A layer dict is
{"norm1", "attn", "norm2", "ffn"} with the reference's leaf names. The
cache is one {"k", "v"} dict of (P, bs, nkv, hd) pools per layer, updated
in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L


def paged_supported(cfg) -> bool:
    """The paged KV path covers pure-attention decoder stacks: recurrent
    mixers (ssm/rglru) carry O(1) state that a prefix block chain cannot
    capture, and enc-dec adds cross caches the block table doesn't model."""
    return (not cfg.is_encdec
            and all(t == "attn" for t in cfg.layer_types()))


def _check_ported(cfg):
    if not paged_supported(cfg):
        raise NotImplementedError(
            f"{cfg.arch_id}: the port runs pure-attention decoders only; "
            "recurrent and enc-dec families are ROADMAP.md Queue 1, 'The "
            "other families'")
    if cfg.moe is not None or cfg.embed_stub:
        raise NotImplementedError(
            f"{cfg.arch_id}: MoE FFNs and modality-prefix embeds are not "
            "ported yet (ROADMAP.md Queue 1, 'The other families')")


def param_shapes(cfg) -> dict:
    """The shape of every parameter, in the port's layout (the weight
    bridge checks the reference's leaves against it)."""
    _check_ported(cfg)
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab_size
    hd, nh, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    attn = {"wq": (d, nh * hd), "wk": (d, nkv * hd), "wv": (d, nkv * hd),
            "wo": (nh * hd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": (hd,)}
        attn["k_norm"] = {"scale": (hd,)}
    ffn = {"w_up": (d, ff), "w_down": (ff, d)}
    if cfg.mlp_gated:
        ffn["w_gate"] = (d, ff)
    layer = {"norm1": {"scale": (d,)}, "attn": attn,
             "norm2": {"scale": (d,)}, "ffn": ffn}
    out = {"embed": {"table": (V, d)}, "layers": [layer] * cfg.n_layers,
           "final_norm": {"scale": (d,)}}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, V)
    return out


def _init_layer(gen, cfg):
    pdt, d = cfg.parameter_dtype, cfg.d_model
    return {"norm1": L.init_rms_norm(d, pdt, gen.device),
            "attn": L.init_attention(gen, cfg),
            "norm2": L.init_rms_norm(d, pdt, gen.device),
            "ffn": L.init_mlp(gen, d, cfg.d_ff, pdt, cfg.mlp_gated)}


def init_lm(gen: torch.Generator, cfg) -> dict:
    """Random weights with the reference's distributions (uniform
    +-1/sqrt(d_in) matrices, N(0, 0.02^2) embedding, zero norm scales),
    drawn from `gen` on `gen.device`. The draws differ from the
    reference's `jax.random` bits; parity tests bridge the reference's
    weights instead (`params.params_from_jax`)."""
    _check_ported(cfg)
    pdt = cfg.parameter_dtype
    params = {"embed": L.init_embedding(gen, cfg.padded_vocab_size,
                                        cfg.d_model, pdt),
              "layers": [_init_layer(gen, cfg) for _ in range(cfg.n_layers)],
              "final_norm": L.init_rms_norm(cfg.d_model, pdt, gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model,
                                         cfg.padded_vocab_size, pdt)
    return params


def _ffn_apply(lp, cfg, h):
    return L.mlp(lp["ffn"], h, cfg.act)


def _logits(params, cfg, x):
    out = L.unembed(params["embed"], x) if cfg.tie_embeddings \
        else x @ params["lm_head"]
    if cfg.padded_vocab_size != cfg.vocab_size:
        # padded vocab entries can never win argmax / contribute to lse
        pad = torch.arange(cfg.padded_vocab_size, device=out.device)
        out = out.masked_fill(pad >= cfg.vocab_size, -1e30)
    return out


# ============================================================== paged cache

def init_paged_cache(cfg, n_pool_blocks: int, block_size: int,
                     device="cuda"):
    """Pool-shaped KV cache: per attention layer, row b of the (P, bs, nkv,
    hd) pool tensors is the bs-token page named by block id b. The same
    block id indexes every layer, so one host-side block table describes a
    sequence across the whole stack. No "pos" leaf: a paged page's gather
    index *is* its absolute position."""
    if not paged_supported(cfg):
        raise ValueError(f"{cfg.arch_id}: paged KV cache requires a pure-"
                         "attention decoder (no ssm/rglru/enc-dec layers)")
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    shape = (n_pool_blocks, block_size, nkv, hd)
    adt = cfg.activation_dtype
    return [{"k": torch.zeros(shape, dtype=adt, device=device),
             "v": torch.zeros(shape, dtype=adt, device=device)}
            for _ in range(cfg.n_layers)]


def copy_pool_blocks(cache, src_ids, dst_ids):
    """Copy whole KV pages src -> dst in every layer's pool, in place (the
    device half of copy-on-write: the host manager picked the ids)."""
    dev = cache[0]["k"].device
    src = torch.as_tensor(src_ids, dtype=torch.long, device=dev)
    dst = torch.as_tensor(dst_ids, dtype=torch.long, device=dev)
    for pool in cache:
        for a in pool.values():
            a[dst] = a[src]
    return cache


def _layer_decode_paged(lp, cfg, x, pos, pool, table, window,
                        kernel="cuda"):
    h = L.apply_rms_norm(lp["norm1"], x, cfg.norm_eps)
    att, _, _ = L.attention_decode_paged(
        lp["attn"], cfg, h, pos, pool["k"], pool["v"], table, window=window,
        kernel=kernel)
    x = x + att
    h = L.apply_rms_norm(lp["norm2"], x, cfg.norm_eps)
    return x + _ffn_apply(lp, cfg, h)


def decode_step_paged(params, cfg, tokens, pos, cache, table, window=None,
                      kernel="cuda"):
    """One decode token per slot over a paged cache. tokens: (B, 1); pos:
    (B,) int32; table: (B, nb) int32 block ids per slot (see
    `init_paged_cache`). Returns (logits (B,1,V), cache). The scatter plus
    kernel-switched attention read per layer is
    `layers.attention_decode_paged`."""
    window = cfg.window if window is None else window
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    for lp, pool in zip(params["layers"], cache):
        x = _layer_decode_paged(lp, cfg, x, pos, pool, table, window, kernel)
    x = L.apply_rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), cache


def _layer_prefill_paged(lp, cfg, x, q_pos, n_tok, pool, table, window):
    h = L.apply_rms_norm(lp["norm1"], x, cfg.norm_eps)
    att, _, _ = L.attention_prefill_paged(
        lp["attn"], cfg, h, q_pos, n_tok, pool["k"], pool["v"], table,
        window=window)
    x = x + att
    h = L.apply_rms_norm(lp["norm2"], x, cfg.norm_eps)
    return x + _ffn_apply(lp, cfg, h)


def forward_prefill_paged(params, cfg, tokens, start, n_tok, cache, table,
                          window=None):
    """Prefill only the *uncached suffix* of a prompt against a paged cache
    whose pages [0, start) are already resident (radix prefix hit).

    tokens: (1, S) suffix tokens, right-padded to the bucket length S;
    start: absolute position of tokens[0, 0]; n_tok: number of real
    (non-pad) tokens; table: (nb,) the slot's block chain. Returns
    (logits (1, S, V), cache) — only logits[:, :n_tok] are meaningful.
    """
    window = cfg.window if window is None else window
    S = tokens.shape[1]
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    q_pos = start + torch.arange(S, dtype=torch.int32, device=x.device)
    for lp, pool in zip(params["layers"], cache):
        x = _layer_prefill_paged(lp, cfg, x, q_pos, n_tok, pool, table,
                                 window)
    x = L.apply_rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), cache
