"""Decoder LM over a dense (ring) or paged KV cache: the serving half of
`repro.models.transformer` for the pure-attention decoders, the RG-LRU
hybrid (recurrentgemma) and Mamba2 (attention-free SSM stacks).

The reference stacks block parameters on a leading n_blocks axis and runs
them with `lax.scan`, then the unstacked tail layers. The port keeps one
parameter dict per layer, blocks then tail in `cfg.layer_types()` order,
and runs a Python loop over layers; `params.params_from_jax` unstacks the
reference's tree into this layout.

Entry points:
    init_lm(gen, cfg)                                     -> params
    forward_train(params, cfg, batch, window=None)        -> (logits, aux)
    forward_prefill(params, cfg, batch, window=None)      -> (logits, caches)
    init_cache(cfg, batch_size, cache_len, device)        -> cache
    decode_step(params, cfg, tokens, pos, cache, window=None, rows=None)
                                                          -> (logits, cache)
    init_paged_cache(cfg, n_pool_blocks, block_size, device) -> cache
    decode_step_paged(params, cfg, tokens, pos, cache, table) -> (logits, cache)
    forward_prefill_paged(params, cfg, tokens, start, n_tok, cache, table)
                                                          -> (logits, cache)
    verify_step_paged(params, cfg, tokens, pos, cache, table)
                                                          -> (logits, cache)
    mixed_step_paged(params, cfg, tokens, pos, n_chunk, cache, table, ctable)
                                                          -> (logits, cache)
    prefill_chunk_paged(params, cfg, tokens, start, n_tok, cache, table)
                                                          -> (logits, cache)
    copy_pool_blocks(cache, src_ids, dst_ids)             -> cache

Params: {"embed": {"table"}, "layers": [per-layer dict], "final_norm":
{"scale"}, and "lm_head" when embeddings are untied}. An attention layer
dict is {"norm1", "attn", "norm2", "ffn"}, an RG-LRU layer dict {"norm1",
"rglru", "norm2", "ffn"}, a Mamba2 layer dict {"norm1", "mamba"} (no FFN,
as in the reference), with the reference's leaf names.

Caches are lists with one dict per layer, updated in place. Dense: {"k",
"v": (B, Sc, nkv, hd), "pos": (B, Sc) int32, -1 = empty} for attention,
{"h": (B, w) f32, "conv": (B, d_conv-1, w)} for RG-LRU, {"ssm": (B, nh,
hd, d_state) f32, "conv": (B, d_conv-1, conv_dim)} for Mamba2. Paged:
{"k", "v"} pools of (P, bs, nkv, hd) per attention layer.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import rglru as RG


def paged_supported(cfg) -> bool:
    """The paged KV path covers pure-attention decoder stacks: recurrent
    mixers (ssm/rglru) carry O(1) state that a prefix block chain cannot
    capture, and enc-dec adds cross caches the block table doesn't model."""
    return (not cfg.is_encdec
            and all(t == "attn" for t in cfg.layer_types()))


def _check_ported(cfg):
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.arch_id}: encoder-decoder cross-attention is not ported "
            "yet (ROADMAP.md Queue 1, 'The other families')")
    if cfg.moe is not None or cfg.embed_stub:
        raise NotImplementedError(
            f"{cfg.arch_id}: MoE FFNs and modality-prefix embeds are not "
            "ported yet (ROADMAP.md Queue 1, 'The other families')")


def _attn_shapes(cfg) -> dict:
    d = cfg.d_model
    hd, nh, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    attn = {"wq": (d, nh * hd), "wk": (d, nkv * hd), "wv": (d, nkv * hd),
            "wo": (nh * hd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": (hd,)}
        attn["k_norm"] = {"scale": (hd,)}
    return attn


def param_shapes(cfg) -> dict:
    """The shape of every parameter, in the port's layout (the weight
    bridge checks the reference's leaves against it)."""
    _check_ported(cfg)
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab_size
    ffn = {"w_up": (d, ff), "w_down": (ff, d)}
    if cfg.mlp_gated:
        ffn["w_gate"] = (d, ff)
    mixer = {"attn": ("attn", _attn_shapes(cfg))}
    if cfg.rglru is not None:
        mixer["rglru"] = ("rglru", RG.param_shapes(cfg))
    layers = []
    for t in cfg.layer_types():
        if t == "ssm":
            layers.append({"norm1": {"scale": (d,)},
                           "mamba": M2.param_shapes(cfg)})
            continue
        name, shapes = mixer[t]
        layers.append({"norm1": {"scale": (d,)}, name: shapes,
                       "norm2": {"scale": (d,)}, "ffn": ffn})
    out = {"embed": {"table": (V, d)}, "layers": layers,
           "final_norm": {"scale": (d,)}}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, V)
    return out


def _init_layer(gen, cfg, ltype: str):
    pdt, d = cfg.parameter_dtype, cfg.d_model
    if ltype == "ssm":
        return {"norm1": L.init_rms_norm(d, pdt, gen.device),
                "mamba": M2.init_mamba2(gen, cfg)}
    if ltype == "attn":
        name, mixer = "attn", L.init_attention(gen, cfg)
    else:
        name, mixer = "rglru", RG.init_rglru_block(gen, cfg)
    return {"norm1": L.init_rms_norm(d, pdt, gen.device),
            name: mixer,
            "norm2": L.init_rms_norm(d, pdt, gen.device),
            "ffn": L.init_mlp(gen, d, cfg.d_ff, pdt, cfg.mlp_gated)}


def init_lm(gen: torch.Generator, cfg) -> dict:
    """Random weights with the reference's distributions (uniform
    +-1/sqrt(d_in) matrices, N(0, 0.02^2) embedding, zero norm scales, the
    RG-LRU's Lambda from a^c in [0.9, 0.999], Mamba2's A_log = log(1..nh)
    and dt_bias spanning [dt_min, dt_max]), drawn from `gen` on
    `gen.device`. The draws differ from the reference's `jax.random` bits;
    parity tests bridge the reference's weights instead
    (`params.params_from_jax`)."""
    _check_ported(cfg)
    pdt = cfg.parameter_dtype
    params = {"embed": L.init_embedding(gen, cfg.padded_vocab_size,
                                        cfg.d_model, pdt),
              "layers": [_init_layer(gen, cfg, t)
                         for t in cfg.layer_types()],
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


# ============================================================== full sequence

def _layer_full(lp, cfg, ltype, x, positions, window):
    """One layer, full sequence. Returns (x, cache at natural length)."""
    h = L.apply_rms_norm(lp["norm1"], x, cfg.norm_eps)
    if ltype == "ssm":
        out, cache = M2.mamba2_forward(lp["mamba"], cfg, h)
        return x + out, cache
    if ltype == "attn":
        att, (k, v) = L.attention(lp["attn"], cfg, h, positions,
                                  causal=True, window=window)
        cache = {"k": k, "v": v,
                 "pos": torch.broadcast_to(positions, x.shape[:2])
                 .to(torch.int32)}
    else:
        att, cache = RG.rglru_block_forward(lp["rglru"], cfg, h)
    x = x + att
    h = L.apply_rms_norm(lp["norm2"], x, cfg.norm_eps)
    return x + _ffn_apply(lp, cfg, h), cache


def forward_prefill(params, cfg, batch, window=None):
    """Full forward over batch["tokens"] (B, S) that also returns each
    layer's cache at natural length (the serving engine copies them into a
    fixed-size ring/linear cache with `serve.step.prefill_into_cache`).
    Returns (logits (B, S, V), caches)."""
    _check_ported(cfg)
    window = cfg.window if window is None else window
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    caches = []
    for lp, t in zip(params["layers"], cfg.layer_types()):
        x, c = _layer_full(lp, cfg, t, x, positions, window)
        caches.append(c)
    x = L.apply_rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), caches


def _zero_aux(device):
    """The reference's MoE aux values (`_zero_aux`); every ported FFN is
    dense, so they are zeros."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("load_balance", "router_z", "dropped_frac")}


def _run_layers(x, layers, types, cfg, positions, window):
    for lp, t in zip(layers, types):
        x, _ = _layer_full(lp, cfg, t, x, positions, window)
    return x


def forward_train(params, cfg, batch, window=None):
    """The training forward over batch["tokens"] (B, S): forward_prefill's
    stack without caches. Returns (logits (B, S, V), aux), aux the
    reference's MoE aux keys over the FFN layer count (zeros here).

    With cfg.remat each pattern block of layers (`len(cfg.block_pattern)`
    layers, the tail excluded) is recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant), as the reference wraps its
    block function in `jax.checkpoint`. `scan_layers` and `seq_parallel`
    change nothing here. Under attention_impl="pallas" the kernels run the
    forward, and a backward through them raises (`kernels.refuse_grad`), as
    the reference's does."""
    _check_ported(cfg)
    window = cfg.window if window is None else window
    x = L.embed(params["embed"], batch["tokens"]).to(cfg.activation_dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    layers, types = params["layers"], cfg.layer_types()
    n_pat = len(cfg.block_pattern)
    n_scan = cfg.n_blocks * n_pat
    for b in range(0, n_scan, n_pat):
        args = (layers[b:b + n_pat], types[b:b + n_pat], cfg, positions,
                window)
        x = (checkpoint(_run_layers, x, *args, use_reentrant=False)
             if cfg.remat else _run_layers(x, *args))
    x = _run_layers(x, layers[n_scan:], types[n_scan:], cfg, positions,
                    window)
    x = L.apply_rms_norm(params["final_norm"], x, cfg.norm_eps)
    n_ffn_layers = sum(1 for t in types if t != "ssm")
    aux = {k: v / max(n_ffn_layers, 1)
           for k, v in _zero_aux(x.device).items()}
    return _logits(params, cfg, x), aux


# ============================================================== dense cache

def init_cache(cfg, batch_size: int, cache_len: int, device="cuda"):
    """Empty dense cache: per attention layer (B, cache_len) K/V slots with
    pos -1; per RG-LRU or Mamba2 layer a zero f32 state and a zero conv
    window."""
    _check_ported(cfg)
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    adt = cfg.activation_dtype

    def one(ltype):
        if ltype == "attn":
            shape = (batch_size, cache_len, nkv, hd)
            return {"k": torch.zeros(shape, dtype=adt, device=device),
                    "v": torch.zeros(shape, dtype=adt, device=device),
                    "pos": torch.full((batch_size, cache_len), -1,
                                      dtype=torch.int32, device=device)}
        if ltype == "ssm":
            s = cfg.ssm
            nh = s.n_heads(cfg.d_model)
            return {"ssm": torch.zeros((batch_size, nh, s.head_dim,
                                        s.d_state), dtype=torch.float32,
                                       device=device),
                    "conv": torch.zeros((batch_size, s.d_conv - 1,
                                         M2.conv_dim(cfg)), dtype=adt,
                                        device=device)}
        w = cfg.rglru.lru_width or cfg.d_model
        return {"h": torch.zeros((batch_size, w), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch_size, cfg.rglru.d_conv - 1, w),
                                    dtype=adt, device=device)}
    return [one(t) for t in cfg.layer_types()]


def _write_rows(cache, new, rows):
    for key, t in new.items():
        cache[key][rows] = t[rows].to(cache[key].dtype)


def _layer_decode(lp, cfg, ltype, x, pos, cache, window, rows):
    h = L.apply_rms_norm(lp["norm1"], x, cfg.norm_eps)
    if ltype == "ssm":
        out, new = M2.mamba2_decode(lp["mamba"], cfg, h, cache)
        _write_rows(cache, new, rows)
        return x + out
    if ltype == "attn":
        att, _, _, _ = L.attention_decode(
            lp["attn"], cfg, h, pos, cache["k"], cache["v"], cache["pos"],
            window=window, rows=rows)
    else:
        att, new = RG.rglru_block_decode(lp["rglru"], cfg, h, cache)
        _write_rows(cache, new, rows)
    x = x + att
    h = L.apply_rms_norm(lp["norm2"], x, cfg.norm_eps)
    return x + _ffn_apply(lp, cfg, h)


def decode_step(params, cfg, tokens, pos, cache, window=None, rows=None):
    """One decode token per slot over the dense cache. tokens: (B, 1); pos:
    (B,) int32 absolute position of the new token; rows: LongTensor of the
    batch rows whose cache this step writes (None = all). Rows left out
    keep their K/V, positions and recurrent state as they were; their
    logits are garbage. Returns (logits (B, 1, V), cache), the cache
    updated in place."""
    window = cfg.window if window is None else window
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    if rows is None:
        rows = torch.arange(x.shape[0], device=x.device)
    for lp, t, c in zip(params["layers"], cfg.layer_types(), cache):
        x = _layer_decode(lp, cfg, t, x, pos, c, window, rows)
    x = L.apply_rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), cache


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


def _layer_verify_paged(lp, cfg, x, pos, pool, table, window):
    h = L.apply_rms_norm(lp["norm1"], x, cfg.norm_eps)
    att, _, _ = L.attention_verify_paged(
        lp["attn"], cfg, h, pos, pool["k"], pool["v"], table, window=window)
    x = x + att
    h = L.apply_rms_norm(lp["norm2"], x, cfg.norm_eps)
    return x + _ffn_apply(lp, cfg, h)


def verify_step_paged(params, cfg, tokens, pos, cache, table, window=None):
    """Multi-token `decode_step_paged`, the speculative-decoding verify
    forward. tokens: (B, T); slot s's tokens occupy absolute positions
    pos[s] + [0, T). All T tokens' K/V are written into the slot's pages
    and all T positions' logits come back from one forward, causal within
    the burst by absolute position. Returns (logits (B, T, V), cache). The
    caller decides afterwards which written positions survive and rewinds
    its frontier past the rest: stale rows beyond the frontier are masked
    by every later read."""
    _check_ported(cfg)
    window = cfg.window if window is None else window
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    for lp, pool in zip(params["layers"], cache):
        x = _layer_verify_paged(lp, cfg, x, pos, pool, table, window)
    x = L.apply_rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), cache


def _layer_mixed_paged(lp, cfg, x, pos, n_chunk, pool, table, ctable,
                       window, kernel):
    h = L.apply_rms_norm(lp["norm1"], x, cfg.norm_eps)
    att, _, _ = L.attention_mixed_paged(
        lp["attn"], cfg, h, pos, n_chunk, pool["k"], pool["v"], table,
        ctable, window=window, kernel=kernel)
    x = x + att
    h = L.apply_rms_norm(lp["norm2"], x, cfg.norm_eps)
    return x + _ffn_apply(lp, cfg, h)


def mixed_step_paged(params, cfg, tokens, pos, n_chunk, cache, table, ctable,
                     window=None, kernel="cuda"):
    """One chunked-prefill scheduler iteration: a single pass over the stack
    for B decode rows plus C chunk rows (`tokens` (B + C,), `pos` (B + C,)
    int32, rows laid out as in `layers.attention_mixed_paged`), with one
    combined pool write per layer. The decode rows' read is kernel-
    switched like `decode_step_paged`'s. Returns (logits (B + C, V),
    cache)."""
    _check_ported(cfg)
    window = cfg.window if window is None else window
    x = L.embed(params["embed"], tokens)[None].to(cfg.activation_dtype)
    for lp, pool in zip(params["layers"], cache):
        x = _layer_mixed_paged(lp, cfg, x, pos, n_chunk, pool, table, ctable,
                               window, kernel)
    x = L.apply_rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x)[0], cache


def _layer_prefill_chunk_paged(lp, cfg, x, start, n_tok, pool, table, window):
    h = L.apply_rms_norm(lp["norm1"], x, cfg.norm_eps)
    att, _, _ = L.attention_prefill_chunk_paged(
        lp["attn"], cfg, h, start, n_tok, pool["k"], pool["v"], table,
        window=window)
    x = x + att
    h = L.apply_rms_norm(lp["norm2"], x, cfg.norm_eps)
    return x + _ffn_apply(lp, cfg, h)


def prefill_chunk_paged(params, cfg, tokens, start, n_tok, cache, table,
                        window=None):
    """One fixed-shape prefill chunk against a paged cache, the chunk-only
    oracle of the mixed step. tokens: (1, C), C the chunk budget; start:
    absolute position of tokens[0, 0]; n_tok: real (non-pad) tokens;
    table: (nb,) the slot's block chain, with positions [0, start) already
    resident. Returns (logits (1, C, V), cache); only logits[:, :n_tok]
    are meaningful."""
    _check_ported(cfg)
    window = cfg.window if window is None else window
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    for lp, pool in zip(params["layers"], cache):
        x = _layer_prefill_chunk_paged(lp, cfg, x, start, n_tok, pool, table,
                                       window)
    x = L.apply_rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), cache
