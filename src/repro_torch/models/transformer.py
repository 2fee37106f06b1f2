"""Decoder and encoder-decoder LM over a dense (ring) or paged KV cache:
the port of `repro.models.transformer` for every family the reference
runs: the pure-attention decoders (dense or MoE FFN), the RG-LRU hybrid
(recurrentgemma), Mamba2 (attention-free SSM stacks), the encoder-decoder
with cross-attention (seamless-m4t) and the decoder with a modality
prefix (pixtral).

The reference stacks block parameters on a leading n_blocks axis and runs
them with `lax.scan`, then the unstacked tail layers. The port keeps one
parameter dict per layer, blocks then tail in `cfg.layer_types()` order,
and runs a Python loop over layers; `params.params_from_jax` unstacks the
reference's tree into this layout.

Entry points:
    init_lm(gen, cfg)                                     -> params
    forward_train(params, cfg, batch, window=None)        -> (logits, aux)
    forward_prefill(params, cfg, batch, window=None, tp=None)
                                                          -> (logits, caches)
    init_cache(cfg, batch_size, cache_len, device, enc_len=0) -> cache
    decode_step(params, cfg, tokens, pos, cache, window=None, rows=None,
                tp=None, split=(False, False))            -> (logits, cache)
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

Batch dict keys, as in the reference: "tokens" (B, S) int; optional
"embeds" (B, P, d), a modality prefix that comes before the tokens
(positions run 0..P+S-1 over both; the prefix rows are dropped from the
logits); optional "enc_embeds" (B, Se, d), the encoder's input for
encoder-decoder models.

Params: {"embed": {"table"}, "layers": [per-layer dict], "final_norm":
{"scale"}, "lm_head" when embeddings are untied, and "encoder":
{"layers": [per-layer dict], "final_norm"} for encoder-decoder models}.
An attention layer dict is {"norm1", "attn", "norm2", "ffn"} plus
{"norm_cross", "cross_attn"} in an encoder-decoder's decoder, an RG-LRU
layer dict {"norm1", "rglru", "norm2", "ffn"}, a Mamba2 layer dict
{"norm1", "mamba"} (no FFN, as in the reference; {"norm1", "mamba",
"norm2", "ffn"} where `cfg.ssm_ffn`, granite-4.0-h), with the reference's
leaf names. An MoE FFN is {"router" (d, E), "w_gate", "w_up" (Ep, d, ff),
"w_down" (Ep, ff, d)} (`models/moe.py`).

Caches are lists with one dict per layer, updated in place. Dense: {"k",
"v": (B, Sc, nkv, hd), "pos": (B, Sc) int32, -1 = empty} for attention,
plus {"cross_k", "cross_v": (B, Se, nkv, hd), "cross_pos": (B, Se)} in an
encoder-decoder (written once by the prefill, read by every decode step),
{"h": (B, w) f32, "conv": (B, d_conv-1, w)} for RG-LRU, {"ssm": (B, nh,
hd, d_state) f32, "conv": (B, d_conv-1, conv_dim)} for Mamba2. Paged:
{"k", "v"} pools of (P, bs, nkv, hd) per attention layer and, in a stack
of attention and Mamba2 layers, the Mamba2 state as on the dense layout
with one row per engine slot.

Granite's port-only settings (`configs.base.ModelConfig`): the embedding
times `embedding_multiplier`, each residual branch times
`residual_multiplier`, the logits divided by `logits_scaling`, the
attention scaled by `attention_multiplier` and no RoPE under `nope`. Each
is skipped at its default, so the other models run the same operations.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.obs import trace as otrace
from repro_torch.sharding import tp as TP
from repro_torch.sharding.rules import constrain


def paged_supported(cfg) -> bool:
    """The paged KV path covers decoder stacks of attention layers, and
    of attention and Mamba2 layers together: a Mamba2 layer's O(1) state
    lives beside the pools, one row per slot (`init_paged_cache`).
    RG-LRU layers, a stack with no attention layer to page, and enc-dec
    (cross caches the block table doesn't model) take the dense layout."""
    types = cfg.layer_types()
    return (not cfg.is_encdec and "attn" in types
            and all(t in ("attn", "ssm") for t in types))


def recurrent(cfg) -> bool:
    """Whether a layer of the stack carries recurrent state."""
    return any(t != "attn" for t in cfg.layer_types())


def _attn_shapes(cfg) -> dict:
    d = cfg.d_model
    hd, nh, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    attn = {"wq": (d, nh * hd), "wk": (d, nkv * hd), "wv": (d, nkv * hd),
            "wo": (nh * hd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": (hd,)}
        attn["k_norm"] = {"scale": (hd,)}
    return attn


def _ffn_shapes(cfg) -> dict:
    d = cfg.d_model
    if cfg.moe:
        ffn = MOE.param_shapes(cfg)
    else:
        ffn = {"w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)}
        if cfg.mlp_gated:
            ffn["w_gate"] = (d, cfg.d_ff)
    return ffn


def _layer_shapes(cfg, ltype: str, with_cross: bool = False) -> dict:
    d = cfg.d_model
    if ltype == "ssm":
        out = {"norm1": {"scale": (d,)}, "mamba": M2.param_shapes(cfg)}
        if cfg.ssm_ffn:
            out.update(norm2={"scale": (d,)}, ffn=_ffn_shapes(cfg))
        return out
    mixer = (_attn_shapes(cfg) if ltype == "attn"
             else RG.param_shapes(cfg))
    out = {"norm1": {"scale": (d,)}, ltype: mixer,
           "norm2": {"scale": (d,)}, "ffn": _ffn_shapes(cfg)}
    if ltype == "attn" and with_cross:
        out["norm_cross"] = {"scale": (d,)}
        out["cross_attn"] = _attn_shapes(cfg)
    return out


def param_shapes(cfg) -> dict:
    """The shape of every parameter, in the port's layout (the weight
    bridge checks the reference's leaves against it)."""
    d, V = cfg.d_model, cfg.padded_vocab_size
    out = {"embed": {"table": (V, d)},
           "layers": [_layer_shapes(cfg, t, cfg.is_encdec)
                      for t in cfg.layer_types()],
           "final_norm": {"scale": (d,)}}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, V)
    if cfg.is_encdec:
        out["encoder"] = {"layers": [_layer_shapes(cfg, "attn")
                                     for _ in range(cfg.n_enc_layers)],
                          "final_norm": {"scale": (d,)}}
    return out


def _init_ffn(gen, cfg):
    return (MOE.init_moe(gen, cfg) if cfg.moe
            else L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.parameter_dtype,
                            cfg.mlp_gated))


def _init_layer(gen, cfg, ltype: str, with_cross: bool = False):
    pdt, d = cfg.parameter_dtype, cfg.d_model
    if ltype == "ssm":
        p = {"norm1": L.init_rms_norm(d, pdt, gen.device),
             "mamba": M2.init_mamba2(gen, cfg)}
        if cfg.ssm_ffn:
            p.update(norm2=L.init_rms_norm(d, pdt, gen.device),
                     ffn=_init_ffn(gen, cfg))
        return p
    if ltype == "attn":
        name, mixer = "attn", L.init_attention(gen, cfg)
    else:
        name, mixer = "rglru", RG.init_rglru_block(gen, cfg)
    p = {"norm1": L.init_rms_norm(d, pdt, gen.device),
         name: mixer,
         "norm2": L.init_rms_norm(d, pdt, gen.device),
         "ffn": _init_ffn(gen, cfg)}
    if ltype == "attn" and with_cross:
        p["norm_cross"] = L.init_rms_norm(d, pdt, gen.device)
        p["cross_attn"] = L.init_attention(gen, cfg)
    return p


def init_lm(gen: torch.Generator, cfg) -> dict:
    """Random weights with the reference's distributions (uniform
    +-1/sqrt(d_in) matrices, the MoE router at +-0.02, N(0, 0.02^2)
    embedding, zero norm scales, the RG-LRU's Lambda from a^c in [0.9,
    0.999], Mamba2's A_log = log(1..nh) and dt_bias spanning [dt_min,
    dt_max]), drawn from `gen` on `gen.device`. The draws differ from the
    reference's `jax.random` bits; parity tests bridge the reference's
    weights instead (`params.params_from_jax`)."""
    pdt = cfg.parameter_dtype
    params = {"embed": L.init_embedding(gen, cfg.padded_vocab_size,
                                        cfg.d_model, pdt),
              "layers": [_init_layer(gen, cfg, t, cfg.is_encdec)
                         for t in cfg.layer_types()],
              "final_norm": L.init_rms_norm(cfg.d_model, pdt, gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model,
                                         cfg.padded_vocab_size, pdt)
    if cfg.is_encdec:
        params["encoder"] = {
            "layers": [_init_layer(gen, cfg, "attn")
                       for _ in range(cfg.n_enc_layers)],
            "final_norm": L.init_rms_norm(cfg.d_model, pdt, gen.device)}
    return params


def _split(tp, part: str):
    """`tp` where the layer part ("heads", "ffn", "vocab", "experts",
    "lru", "ssm") splits over "model" (`sharding.tp`), else None: the
    part runs whole."""
    return None if tp is None else tp.part(part)


def _ffn_apply(lp, cfg, h, want_aux: bool = False, tp=None,
               batch_groups=()):
    """The layer's FFN: (out, aux). aux is the MoE's aux dict when
    `want_aux` and the FFN is an MoE, else None (its load balance over
    the global batch with `batch_groups`, `moe.moe_ffn`)."""
    if cfg.moe:
        return MOE.moe_ffn(lp["ffn"], cfg, h, want_aux=want_aux,
                           tp=_split(tp, "experts"),
                           batch_groups=batch_groups)
    with otrace.region("ffn"):
        return L.mlp(lp["ffn"], h, cfg.act, _split(tp, "ffn")), None


def _res(cfg, x, branch):
    """x plus a residual branch, the branch times `residual_multiplier`
    where that is set."""
    m = cfg.residual_multiplier
    return x + branch if m == 1.0 else x + branch * m


def _ffn_block(lp, cfg, x, want_aux=False, tp=None, batch_groups=()):
    """norm2, the FFN and its residual add: (x, aux)."""
    h = L.apply_rms_norm(lp["norm2"], x, cfg.norm_eps)
    ff, aux = _ffn_apply(lp, cfg, h, want_aux, tp, batch_groups)
    return _res(cfg, x, ff), aux


def _ssm_tail(lp, cfg, x, out, want_aux=False, tp=None, batch_groups=()):
    """A Mamba2 layer after its mixer: the residual add of `out`, then
    norm2 and the FFN where the config gives it one: (x, aux)."""
    x = _res(cfg, x, out)
    if not cfg.ssm_ffn:
        return x, None
    return _ffn_block(lp, cfg, x, want_aux, tp, batch_groups)


def _embed(params, cfg, tokens, tp=None):
    """Token embeddings in the activation dtype, times
    `embedding_multiplier` where that is set."""
    x = L.embed(params["embed"], tokens, _split(tp, "vocab")).to(
        cfg.activation_dtype)
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


def _logits(params, cfg, x, tp=None):
    """Logits over the (padded) vocabulary; with a tensor-parallel context
    whose vocabulary splits, this rank's (..., V/tp) slice of them, the
    padding masked at the rank's offset: the full logits never exist."""
    tp = _split(tp, "vocab")
    if tp is not None and not cfg.tie_embeddings:
        x = TP.copy_to_model(x, tp)
    out = L.unembed(params["embed"], x, tp) if cfg.tie_embeddings \
        else x @ params["lm_head"]
    if cfg.logits_scaling != 1.0:
        out = out / cfg.logits_scaling
    if cfg.padded_vocab_size != cfg.vocab_size:
        # padded vocab entries can never win argmax / contribute to lse
        lo = 0 if tp is None else tp.rank * out.shape[-1]
        pad = torch.arange(lo, lo + out.shape[-1], device=out.device)
        out = out.masked_fill(pad >= cfg.vocab_size, -1e30)
    # vocab-sharded logits on a mesh (a no-op without one)
    return constrain(out, ("batch", None, "model"))


def _final_logits(params, cfg, x):
    """The final norm and the logits: the serving steps' "logits"
    region."""
    with otrace.region("logits"):
        x = L.apply_rms_norm(params["final_norm"], x, cfg.norm_eps)
        return _logits(params, cfg, x)


# ============================================================== full sequence

def _layer_full(lp, cfg, ltype, x, positions, window, enc=None,
                want_aux=False, want_cache=False, tp=None, batch_groups=()):
    """One layer, full sequence. `enc` is (encoder output, its positions)
    for an encoder-decoder's decoder, else None. Returns (x, cache at
    natural length, aux or None); `want_cache` (the prefill) puts the
    emitted k/v in the prefill-cache layout on a mesh, and under `tp`
    keeps every kv head the rank projects (all of them where the kv heads
    do not split) and makes a recurrent layer's state whole (one
    all-reduce: `rglru.whole_state`, `mamba2.whole_state`; the training
    forward pays none). `tp`: tensor
    parallel over "model" (`sharding.tp`; each mixer and the FFN take it
    where their part splits; `enc`'s output then already inside the head
    split, `_stack_inputs`).
    `batch_groups`: the MoE's, `_ffn_apply`."""
    h = L.apply_rms_norm(lp["norm1"], x, cfg.norm_eps)
    if ltype == "ssm":
        part = _split(tp, "ssm")
        out, cache = M2.mamba2_forward(lp["mamba"], cfg, h, tp=part)
        if want_cache and part is not None:
            cache = M2.whole_state(cfg, cache, part)
        x, aux = _ssm_tail(lp, cfg, x, out, want_aux, tp, batch_groups)
        return x, cache, aux
    if ltype == "attn":
        att, (k, v) = L.attention(lp["attn"], cfg, h, positions,
                                  causal=True, window=window,
                                  constrain_kv=want_cache,
                                  tp=_split(tp, "heads"), all_kv=want_cache)
        cache = {"k": k, "v": v,
                 "pos": torch.broadcast_to(positions, x.shape[:2])
                 .to(torch.int32)}
    else:
        part = _split(tp, "lru")
        att, cache = RG.rglru_block_forward(lp["rglru"], cfg, h, tp=part)
        if want_cache and part is not None:
            cache = RG.whole_state(cache, part)
    x = _res(cfg, x, att)
    if ltype == "attn" and enc is not None:
        h = L.apply_rms_norm(lp["norm_cross"], x, cfg.norm_eps)
        catt, (ck, cv) = L.attention(lp["cross_attn"], cfg, h, positions,
                                     kv=enc[0], kv_positions=enc[1],
                                     causal=False, rope=False,
                                     constrain_kv=want_cache,
                                     tp=_split(tp, "heads"),
                                     all_kv=want_cache)
        x = x + catt
        cache["cross_k"], cache["cross_v"] = ck, cv
    x, aux = _ffn_block(lp, cfg, x, want_aux, tp, batch_groups)
    return x, cache, aux


def _encode(params, cfg, enc_embeds, tp=None):
    """The encoder stack: non-causal self-attention (with RoPE) over the
    stub embeddings. Returns (encoder output, its positions (1, Se)).
    With `tp` its layers split as the dense decoder's do."""
    enc_pos = torch.arange(enc_embeds.shape[1],
                           device=enc_embeds.device)[None, :]
    x = enc_embeds.to(cfg.activation_dtype)
    for lp in params["encoder"]["layers"]:
        y = L.apply_rms_norm(lp["norm1"], x, cfg.norm_eps)
        att, _ = L.attention(lp["attn"], cfg, y, enc_pos, causal=False,
                             tp=_split(tp, "heads"))
        x = x + att
        y = L.apply_rms_norm(lp["norm2"], x, cfg.norm_eps)
        ff, _ = _ffn_apply(lp, cfg, y, tp=tp)
        x = x + ff
    x = L.apply_rms_norm(params["encoder"]["final_norm"], x, cfg.norm_eps)
    return x, enc_pos


def _inputs_to_x(params, cfg, batch, tp=None):
    """Token embedding after the optional modality prefix. Returns (x,
    positions (1, P + S), P)."""
    x = _embed(params, cfg, batch["tokens"], tp)
    n_prefix = 0
    if batch.get("embeds") is not None:
        pre = batch["embeds"].to(cfg.activation_dtype)
        n_prefix = pre.shape[1]
        x = torch.cat([pre, x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return constrain(x, ("batch", None, None)), positions, n_prefix


def _stack_inputs(params, cfg, batch, tp=None):
    """(x, positions, n_prefix, enc) for a full-sequence pass. Where the
    heads split over "model", the encoder's output enters the split here,
    once (`copy_to_model`: one all-reduce in the backward for every
    cross-attention's keys and values)."""
    enc = None
    if cfg.is_encdec:
        enc = _encode(params, cfg, batch["enc_embeds"], tp)
        heads = _split(tp, "heads")
        if heads is not None:
            enc = (TP.copy_to_model(enc[0], heads), enc[1])
    return _inputs_to_x(params, cfg, batch, tp) + (enc,)


def _head(params, cfg, x, n_prefix, tp=None):
    x = L.apply_rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x[:, n_prefix:], tp)


def forward_prefill(params, cfg, batch, window=None, tp=None):
    """Full forward over batch["tokens"] (B, S), after batch["embeds"]
    where given and over the encoder's output of batch["enc_embeds"] in an
    encoder-decoder, that also returns each layer's cache at natural
    length (prefix positions included; the serving engine copies them into
    a fixed-size ring/linear cache with `serve.step.prefill_into_cache`).
    Returns (logits (B, S, V) over the token positions, caches); an
    encoder-decoder's caches carry the cross K/V.

    With a tensor-parallel context `tp` (`sharding.tp`, every family:
    `tp.in_scope`) params hold this rank's shards, the layers split as in
    `forward_train`, the logits are the rank's (..., V/tp) slice, each
    cache's k/v (cross k/v too) are the rank's kv heads where those
    split, else every kv head, and each recurrent state is whole (the
    reference's batch-only layout, `rules.cache_specs`)."""
    if tp is not None and not TP.in_scope(cfg):
        raise ValueError(f"{cfg.arch_id}: no tensor-parallel forward for "
                         "this family")
    window = cfg.window if window is None else window
    x, positions, n_prefix, enc = _stack_inputs(params, cfg, batch, tp)
    caches = []
    n_pat = len(cfg.block_pattern)
    for li, (lp, t) in enumerate(zip(params["layers"], cfg.layer_types())):
        x, c, _ = _layer_full(lp, cfg, t, x, positions, window, enc,
                              want_cache=True, tp=tp)
        caches.append(c)
        if li < cfg.n_blocks * n_pat and li % n_pat == n_pat - 1:
            x = _seq_parallel(cfg, x)
    return _head(params, cfg, x, n_prefix, tp), caches


def _seq_parallel(cfg, x):
    """After each pattern block, under cfg.seq_parallel: Megatron-SP, the
    residual stream seq-sharded over "model" on a mesh (the reference
    constrains its scan carry so); a no-op without one."""
    return constrain(x, ("batch", "model", None)) if cfg.seq_parallel else x


def _zero_aux(device):
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("load_balance", "router_z", "dropped_frac")}


def _run_layers(x, aux, layers, types, cfg, positions, window, enc,
                tp=None, batch_groups=()):
    """Layers over the full sequence, the MoE aux summed into `aux` (a new
    dict). Returns (x, aux)."""
    aux = dict(aux)
    for lp, t in zip(layers, types):
        x, _, a = _layer_full(lp, cfg, t, x, positions, window, enc,
                              want_aux=True, tp=tp, batch_groups=batch_groups)
        if a is not None:
            aux = {k: aux[k] + a[k] for k in aux}
    return x, aux


def forward_train(params, cfg, batch, window=None, tp=None, batch_groups=()):
    """The training forward: forward_prefill's stack without caches.
    Returns (logits (B, S, V) over the token positions, aux), aux the MoE
    aux values ("load_balance", "router_z", "dropped_frac") summed over
    the layers and divided by the FFN layer count (zeros without MoE), as
    in the reference.

    With cfg.remat each pattern block of layers (`len(cfg.block_pattern)`
    layers, the tail excluded) is recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant; the aux pass through it), as
    the reference wraps its block function in `jax.checkpoint`. The
    encoder is not recomputed (the reference scans it outside the
    checkpoint too). `scan_layers` changes nothing here: the layer loop is
    Python and has no scan to unroll. `seq_parallel` and the reference's
    other sharding hints (`sharding.rules.constrain`: embeddings, logits,
    MoE buffers) lay out DTensor activations under an ambient mesh and
    return their input unchanged otherwise; the mesh train step
    (`sharding.spmd`) runs the layers on local tensors, where they do
    nothing.
    Under attention_impl="pallas" the kernels run the forward, and a
    backward through them raises (`kernels.refuse_grad`), as the
    reference's does.

    With a tensor-parallel context `tp` (`sharding.tp`; every family,
    `tp.in_scope`) params hold this rank's shards of the leaves the
    "model" axis splits, each layer runs its heads and its FFN columns or
    experts (the encoder's layers and the cross-attention too), its
    RG-LRU channels or its Mamba2 heads, and the logits are the rank's
    vocabulary slice (the loss: `tp.vocab_parallel_xent`). Under remat
    the recomputed forward repeats the all-reduces the backward needs:
    torch's checkpoint stops after the last value a block's backward
    reads, so an output only added to the residual stream at a block's
    end (the last layer's FFN or mixer) is not recomputed.

    `batch_groups` (`sharding.spmd.batch_groups`: `batch` is this rank's
    rows of a batch split over them) makes the MoE load balance the
    global batch's. They are an argument of each checkpointed block, so
    its recompute, on autograd's own thread on a card, gets them too."""
    if tp is not None and not TP.in_scope(cfg):
        raise ValueError(f"{cfg.arch_id}: no tensor-parallel forward for "
                         "this family")
    window = cfg.window if window is None else window
    x, positions, n_prefix, enc = _stack_inputs(params, cfg, batch, tp)
    aux = _zero_aux(x.device)
    layers, types = params["layers"], cfg.layer_types()
    n_pat = len(cfg.block_pattern)
    n_scan = cfg.n_blocks * n_pat
    for b in range(0, n_scan, n_pat):
        args = (layers[b:b + n_pat], types[b:b + n_pat], cfg, positions,
                window, enc, tp, batch_groups)
        x, aux = (checkpoint(_run_layers, x, aux, *args, use_reentrant=False)
                  if cfg.remat else _run_layers(x, aux, *args))
        x = _seq_parallel(cfg, x)
    x, aux = _run_layers(x, aux, layers[n_scan:], types[n_scan:], cfg,
                         positions, window, enc, tp, batch_groups)
    n_ffn_layers = sum(1 for t in types if t != "ssm" or cfg.ssm_ffn)
    aux = {k: v / max(n_ffn_layers, 1) for k, v in aux.items()}
    return _head(params, cfg, x, n_prefix, tp), aux


# ============================================================== dense cache

def init_cache(cfg, batch_size: int, cache_len: int, device="cuda",
               enc_len: int = 0):
    """Empty dense cache: per attention layer (B, cache_len) K/V slots with
    pos -1, plus zero (B, enc_len) cross K/V with cross_pos 0 in an
    encoder-decoder when enc_len > 0; per RG-LRU or Mamba2 layer a zero
    f32 state and a zero conv window."""
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    adt = cfg.activation_dtype

    def one(ltype):
        if ltype == "attn":
            shape = (batch_size, cache_len, nkv, hd)
            c = {"k": torch.zeros(shape, dtype=adt, device=device),
                 "v": torch.zeros(shape, dtype=adt, device=device),
                 "pos": torch.full((batch_size, cache_len), -1,
                                   dtype=torch.int32, device=device)}
            if cfg.is_encdec and enc_len > 0:
                cshape = (batch_size, enc_len, nkv, hd)
                c["cross_k"] = torch.zeros(cshape, dtype=adt, device=device)
                c["cross_v"] = torch.zeros(cshape, dtype=adt, device=device)
                c["cross_pos"] = torch.zeros((batch_size, enc_len),
                                             dtype=torch.int32, device=device)
            return c
        if ltype == "ssm":
            return _ssm_state(cfg, batch_size, device)
        w = cfg.rglru.lru_width or cfg.d_model
        return {"h": torch.zeros((batch_size, w), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch_size, cfg.rglru.d_conv - 1, w),
                                    dtype=adt, device=device)}
    return [one(t) for t in cfg.layer_types()]


def _ssm_state(cfg, batch_size: int, device):
    """A Mamba2 layer's zero state: {"ssm": (B, nh, hd, d_state) f32,
    "conv": (B, d_conv-1, conv_dim)}."""
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    return {"ssm": torch.zeros((batch_size, nh, s.head_dim, s.d_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch_size, s.d_conv - 1, M2.conv_dim(cfg)),
                                dtype=cfg.activation_dtype, device=device)}


def _write_rows(cache, new, rows):
    for key, t in new.items():
        cache[key][rows] = t[rows].to(cache[key].dtype)


def _layer_decode(lp, cfg, ltype, x, pos, cache, window, rows, tp=None,
                  split=(False, False)):
    """One layer's decode step, the cache written in place (a recurrent
    state only in `rows`). Under `tp` a recurrent mixer steps its part of
    the whole state and makes the new state whole before the write, every
    rank joining that all-reduce whatever `rows` holds."""
    h = L.apply_rms_norm(lp["norm1"], x, cfg.norm_eps)
    if ltype == "ssm":
        out, new = M2.mamba2_decode(lp["mamba"], cfg, h, cache,
                                    tp=_split(tp, "ssm"))
        _write_rows(cache, new, rows)
        return _ssm_tail(lp, cfg, x, out, tp=tp)[0]
    if ltype == "attn":
        att, _, _, _ = L.attention_decode(
            lp["attn"], cfg, h, pos, cache["k"], cache["v"], cache["pos"],
            window=window, rows=rows, tp=tp, split=split[0])
    else:
        att, new = RG.rglru_block_decode(lp["rglru"], cfg, h, cache,
                                         tp=_split(tp, "lru"))
        _write_rows(cache, new, rows)
    x = _res(cfg, x, att)
    if cfg.is_encdec and "cross_k" in cache:
        h = L.apply_rms_norm(lp["norm_cross"], x, cfg.norm_eps)
        catt, _, _, _ = L.attention_decode(
            lp["cross_attn"], cfg, h, pos, cache["cross_k"],
            cache["cross_v"], cache["cross_pos"], rope=False, cross=True,
            tp=tp, split=split[1])
        x = x + catt
    return _ffn_block(lp, cfg, x, tp=tp)[0]


def decode_step(params, cfg, tokens, pos, cache, window=None, rows=None,
                tp=None, split=(False, False)):
    """One decode token per slot over the dense cache. tokens: (B, 1); pos:
    (B,) int32 absolute position of the new token; rows: LongTensor of the
    batch rows whose cache this step writes (None = all). Rows left out
    keep their K/V, positions and recurrent state as they were; their
    logits are garbage. An encoder-decoder's layers also read their cross
    caches (no RoPE, every entry with cross_pos >= 0). Returns (logits (B,
    1, V), cache), the cache updated in place.

    With a tensor-parallel context `tp` (`sharding.tp`, every family)
    params hold this rank's shards: the vocab-parallel embedding, each
    attention over its heads (`layers.attention_decode`; `split` = (self,
    cross): whether the self- and cross-attention caches hold this rank's
    slice of the sequence, `tp.cache_split`), each RG-LRU block over its
    channels and each Mamba2 block over its heads of the whole state
    (`rglru_block_decode`, `mamba2_decode`), the FFN's columns or experts,
    and the rank's (B, 1, V/tp) slice of the logits. `rows` index the
    rank's own rows of the batch."""
    if tp is not None and not TP.in_scope(cfg):
        raise ValueError(f"{cfg.arch_id}: no tensor-parallel forward for "
                         "this family")
    window = cfg.window if window is None else window
    x = _embed(params, cfg, tokens, tp)
    if rows is None:
        rows = torch.arange(x.shape[0], device=x.device)
    for lp, t, c in zip(params["layers"], cfg.layer_types(), cache):
        x = _layer_decode(lp, cfg, t, x, pos, c, window, rows, tp, split)
    x = L.apply_rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x, tp), cache


# ============================================================== paged cache

def init_paged_cache(cfg, n_pool_blocks: int, block_size: int,
                     device="cuda", slots: int = 0):
    """Pool-shaped KV cache: per attention layer, row b of the (P, bs, nkv,
    hd) pool tensors is the bs-token page named by block id b. The same
    block id indexes every layer, so one host-side block table describes a
    sequence across the whole stack. No "pos" leaf: a paged page's gather
    index *is* its absolute position. Per Mamba2 layer, `slots` rows of
    state, row s slot s's: {"ssm": (slots, nh, hd, d_state) f32, "conv":
    (slots, d_conv-1, conv_dim)}, zeros (`paged_supported`)."""
    if not paged_supported(cfg):
        raise ValueError(f"{cfg.arch_id}: paged KV cache requires a decoder "
                         "of attention layers, or of attention and Mamba2 "
                         "layers (no rglru/enc-dec layers)")
    if recurrent(cfg) and slots < 1:
        raise ValueError(f"{cfg.arch_id}: a paged cache with Mamba2 layers "
                         "needs the slot count for their state")
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    shape = (n_pool_blocks, block_size, nkv, hd)
    adt = cfg.activation_dtype

    def one(ltype):
        if ltype == "ssm":
            return _ssm_state(cfg, slots, device)
        return {"k": torch.zeros(shape, dtype=adt, device=device),
                "v": torch.zeros(shape, dtype=adt, device=device)}
    return [one(t) for t in cfg.layer_types()]


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


def _stack_paged(params, cfg, x, cache, attend, ssm=None):
    """The paged layer stack, one for the five paged entry points: per
    layer norm1, the mixer (`attend(p, h, pool)` for an attention layer,
    `ssm(p, h, pool)` for a Mamba2 layer, each returning the mixer's
    output), its residual add, then `_ffn_block` or `_ssm_tail`; then
    `_final_logits`. Only the attention read differs between the entry
    points, so every model setting reaches all five here."""
    for lp, t, pool in zip(params["layers"], cfg.layer_types(), cache):
        h = L.apply_rms_norm(lp["norm1"], x, cfg.norm_eps)
        if t == "ssm":
            x = _ssm_tail(lp, cfg, x, ssm(lp["mamba"], h, pool))[0]
        else:
            x = _res(cfg, x, attend(lp["attn"], h, pool))
            x = _ffn_block(lp, cfg, x)[0]
    return _final_logits(params, cfg, x)


def decode_step_paged(params, cfg, tokens, pos, cache, table, window=None,
                      kernel="cuda"):
    """One decode token per slot over a paged cache. tokens: (B, 1); pos:
    (B,) int32; table: (B, nb) int32 block ids per slot (see
    `init_paged_cache`). Returns (logits (B,1,V), cache). The scatter plus
    kernel-switched attention read per layer is
    `layers.attention_decode_paged`. A Mamba2 layer steps row b of its
    state in place where slot b is live, i.e. where its table row names a
    page (`table[:, 0] != 0`: an empty or dead slot's row is all zeros),
    so B is the engine's slot count there."""
    window = cfg.window if window is None else window
    x = _embed(params, cfg, tokens)
    live = (table[:, 0] != 0) if recurrent(cfg) else None

    def attend(p, h, pool):
        return L.attention_decode_paged(p, cfg, h, pos, pool["k"], pool["v"],
                                        table, window=window,
                                        kernel=kernel)[0]

    def ssm(p, h, pool):
        return M2.mamba2_decode_paged(p, cfg, h, pool, live)
    return _stack_paged(params, cfg, x, cache, attend, ssm), cache


def forward_prefill_paged(params, cfg, tokens, start, n_tok, cache, table,
                          window=None, kernel="cuda", slot=None):
    """Prefill only the *uncached suffix* of a prompt against a paged cache
    whose pages [0, start) are already resident (radix prefix hit).

    tokens: (1, S) suffix tokens, right-padded to the bucket length S;
    start: absolute position of tokens[0, 0] (an int); n_tok: number of
    real (non-pad) tokens; table: (nb,) the slot's block chain. Returns
    (logits (1, S, V), cache) — only logits[:, :n_tok] are meaningful.
    `kernel` switches each layer's attention read
    (`layers.attention_prefill_paged`: "cuda" or "reference").

    A stack with Mamba2 layers prefills a whole prompt (start 0) at its
    exact length (S == n_tok: a pad token would advance the state), and
    each Mamba2 layer writes its final state into row `slot` of its state
    (`mamba2.mamba2_prefill_paged`), overwriting what the slot held.
    """
    if recurrent(cfg) and (slot is None or start != 0 or
                           tokens.shape[1] != n_tok):
        raise ValueError(f"{cfg.arch_id}: a prefill with Mamba2 layers runs "
                         "a whole prompt, unpadded, into a slot (slot=, "
                         f"start 0, S == n_tok); got slot={slot}, start="
                         f"{start}, S={tokens.shape[1]}, n_tok={n_tok}")
    window = cfg.window if window is None else window
    S = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    q_pos = start + torch.arange(S, dtype=torch.int32, device=x.device)

    def attend(p, h, pool):
        return L.attention_prefill_paged(p, cfg, h, q_pos, n_tok, pool["k"],
                                         pool["v"], table, window=window,
                                         kernel=kernel, start=start)[0]

    def ssm(p, h, pool):
        return M2.mamba2_prefill_paged(p, cfg, h, pool, slot)
    return _stack_paged(params, cfg, x, cache, attend, ssm), cache


def _attention_only(cfg, what: str):
    if recurrent(cfg):
        raise ValueError(f"{cfg.arch_id}: {what} runs attention stacks "
                         "only; a stack with recurrent layers has no "
                         "per-position state to verify, chunk or roll back")


def verify_step_paged(params, cfg, tokens, pos, cache, table, window=None):
    """Multi-token `decode_step_paged`, the speculative-decoding verify
    forward. tokens: (B, T); slot s's tokens occupy absolute positions
    pos[s] + [0, T). All T tokens' K/V are written into the slot's pages
    and all T positions' logits come back from one forward, causal within
    the burst by absolute position. Returns (logits (B, T, V), cache). The
    caller decides afterwards which written positions survive and rewinds
    its frontier past the rest: stale rows beyond the frontier are masked
    by every later read."""
    _attention_only(cfg, "the speculative verify")
    window = cfg.window if window is None else window
    x = _embed(params, cfg, tokens)

    def attend(p, h, pool):
        return L.attention_verify_paged(p, cfg, h, pos, pool["k"], pool["v"],
                                        table, window=window)[0]
    return _stack_paged(params, cfg, x, cache, attend), cache


def mixed_step_paged(params, cfg, tokens, pos, n_chunk, cache, table, ctable,
                     window=None, kernel="cuda"):
    """One chunked-prefill scheduler iteration: a single pass over the stack
    for B decode rows plus C chunk rows (`tokens` (B + C,), `pos` (B + C,)
    int32, rows laid out as in `layers.attention_mixed_paged`), with one
    combined pool write per layer. The decode rows' read is kernel-
    switched like `decode_step_paged`'s. Returns (logits (B + C, V),
    cache)."""
    _attention_only(cfg, "the chunked mixed step")
    window = cfg.window if window is None else window
    x = _embed(params, cfg, tokens)[None]

    def attend(p, h, pool):
        return L.attention_mixed_paged(p, cfg, h, pos, n_chunk, pool["k"],
                                       pool["v"], table, ctable,
                                       window=window, kernel=kernel)[0]
    return _stack_paged(params, cfg, x, cache, attend)[0], cache


def prefill_chunk_paged(params, cfg, tokens, start, n_tok, cache, table,
                        window=None):
    """One fixed-shape prefill chunk against a paged cache, the chunk-only
    oracle of the mixed step. tokens: (1, C), C the chunk budget; start:
    absolute position of tokens[0, 0]; n_tok: real (non-pad) tokens;
    table: (nb,) the slot's block chain, with positions [0, start) already
    resident. Returns (logits (1, C, V), cache); only logits[:, :n_tok]
    are meaningful."""
    _attention_only(cfg, "a prefill chunk")
    window = cfg.window if window is None else window
    x = _embed(params, cfg, tokens)

    def attend(p, h, pool):
        return L.attention_prefill_chunk_paged(p, cfg, h, start, n_tok,
                                               pool["k"], pool["v"], table,
                                               window=window)[0]
    return _stack_paged(params, cfg, x, cache, attend), cache
