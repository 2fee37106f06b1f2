"""Core composable layers: norms, RoPE, GQA attention (prefill, dense
ring-cache decode and paged decode), gated MLPs. Plain functions over
parameter dicts of tensors, as in the reference (`repro.models.layers`),
with the same layouts: weights are `(d_in, d_out)` and applied as `x @ W`,
activations are `(B, S, ...)`.

Attention supports:
  * grouped-query (n_kv_heads <= n_heads)
  * optional per-head RMS qk-norm (qwen3)
  * causal, sliding-window and cross (non-causal) masking
  * full-sequence causal attention through the flash-attention kernel
    (`cfg.attention_impl == "pallas"`) or the dense composition ("xla")
  * single-token decode over a dense ring cache; over a paged KV pool,
    decode, suffix prefill, the speculative verify (T tokens per slot),
    one prefill chunk, and the chunked scheduler's mixed decode + chunk

One difference from the reference: JAX arrays are immutable, so the
reference's cache writes (`kpool.at[blk, off].set(...)`, the one-hot blend
of `attention_decode`) return fresh arrays. The port writes the new K/V
rows into the cache tensors in place (`index_put_`) and returns the same
tensors, which saves a cache copy per layer per step. The dense decode
writes only the batch rows it is told to (`rows`), so a step that runs
some slots leaves the others' caches as they were.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.obs import trace as otrace
from repro_torch.sharding import tp as TP
from repro_torch.sharding.rules import constrain

# ----------------------------------------------------------------------------- init


def uniform_init(gen: torch.Generator, shape, scale, dtype):
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return ((2.0 * u - 1.0) * scale).to(dtype)


def dense_init(gen, d_in, d_out, dtype, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return uniform_init(gen, (d_in, d_out), scale, dtype)


# ----------------------------------------------------------------------------- norms

def rms_norm(x, weight, eps=1e-6, tp=None):
    """With a tensor-parallel context (`sharding.tp`) x and weight hold
    this rank's 1/tp of the normalised dim: the sum of squares is summed
    over the model ranks (`sum_over_model`) and divided by the full
    width."""
    dt = x.dtype
    x = x.float()
    if tp is None:
        ms = (x * x).mean(dim=-1, keepdim=True)
    else:
        ms = TP.sum_over_model((x * x).sum(dim=-1, keepdim=True), tp) \
            / (x.shape[-1] * tp.size)
    x = x * torch.rsqrt(ms + eps)
    return (x * (1.0 + weight.float())).to(dt)


def init_rms_norm(d, dtype, device):
    # stored as (1 + scale)
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def apply_rms_norm(params, x, eps=1e-6):
    return rms_norm(x, params["scale"], eps)


# ----------------------------------------------------------------------------- acts

ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


# ----------------------------------------------------------------------------- rope

def rope_frequencies(head_dim: int, theta: float, device=None):
    ex = torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=device) / head_dim
    return 1.0 / (theta ** ex)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Split-
    halves form, angles in f32."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)
    ang = positions[..., None].float() * inv                  # (..., S, hd/2)
    ang = ang[..., None, :]                                   # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------- attention

def init_attention(gen, cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    pdt = cfg.parameter_dtype
    p = {
        "wq": dense_init(gen, d, nh * hd, pdt),
        "wk": dense_init(gen, d, nkv * hd, pdt),
        "wv": dense_init(gen, d, nkv * hd, pdt),
        "wo": dense_init(gen, nh * hd, d, pdt),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, pdt, gen.device)
        p["k_norm"] = init_rms_norm(hd, pdt, gen.device)
    return p


def _attn_mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    """Boolean mask (..., Sq, Sk): True = attend."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window is not None:
        m &= kp > qp - window
    return m


def _sdpa_xla(q, k, v, mask, scale):
    """q:(B,Sq,nh,hd) k,v:(B,Sk,nkv,hd), mask (B,Sq,Sk). GQA by reshaping q
    to (nkv, rep).

    The reference keeps inputs in their storage dtype and accumulates in
    f32; the port upcasts the inputs to f32, which gives the same sums.
    Softmax is in f32, and the probabilities are rounded to q's dtype
    before the PV product, as in the reference. Masked logits take
    finfo(f32).min, not -inf, so a fully masked row yields the mean of V
    (callers never read such rows).
    """
    B, Sq, nh, hd = q.shape
    nkv = k.shape[2]
    rep = nh // nkv
    qr = q.reshape(B, Sq, nkv, rep, hd)
    logits = torch.einsum("bqkrh,bskh->bkrqs", qr.float(), k.float()) * scale
    neg = torch.finfo(torch.float32).min
    logits = logits.masked_fill(~mask[:, None, None, :, :], neg)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrqs,bskh->bqkrh", w.to(q.dtype).float(), v.float())
    return out.reshape(B, Sq, nh, hd).to(q.dtype)


def _project_qkv(params, cfg, x, src, tp=None, all_kv=False):
    """q (B, S, nh, hd), k and v (B, Sk, nkv, hd); with `src` None (a
    cross decode's read of its cache) q only, and k = v = None. With a
    tensor-parallel context (`sharding.tp`): this rank's query heads (wq's
    local columns) and the kv heads they read, from wk/wv's local columns
    where the kv heads split, else from the gathered leaves' columns of
    `tp.kv_heads` (with `all_kv`, every kv head: the prefill keeps them
    all)."""
    B, S, _ = x.shape
    hd, nh, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    wk, wv = params["wk"], params["wv"]
    if tp is not None:
        nh = tp.local_heads(cfg)
        if not tp.kv and not all_kv:
            heads = tp.kv_heads(cfg)
            wk, wv = (w.reshape(w.shape[0], nkv, hd)[:, heads].flatten(1)
                      for w in (wk, wv))
        nkv = wk.shape[1] // hd
    q = (x @ params["wq"]).reshape(B, S, nh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"]["scale"], cfg.norm_eps)
    if src is None:
        return q, None, None
    k = (src @ wk).reshape(B, src.shape[1], nkv, hd)
    v = (src @ wv).reshape(B, src.shape[1], nkv, hd)
    if cfg.qk_norm:
        k = rms_norm(k, params["k_norm"]["scale"], cfg.norm_eps)
    return q, k, v


def attention(params, cfg, x, positions, *, kv=None, kv_positions=None,
              causal=True, window=None, rope=True, constrain_kv=False,
              tp=None, all_kv=False):
    """Full-sequence attention (prefill / encoder / cross).

    x: (B, S, d). kv: optional (B, Sk, d) source for cross-attention.
    Returns (out, (k, v)). Causal self-attention with
    ``cfg.attention_impl == "pallas"`` goes through the flash-attention
    kernel (`kernels/flash_attention`: the CUDA kernel on CUDA tensors, its
    plain version on CPU tensors), which takes positions 0..S-1 as the
    reference's kernel does; everything else through `_sdpa_xla`. With
    ``constrain_kv`` the emitted k/v take the prefill-cache layout (batch
    over data, head_dim over model; `sharding.rules.constrain`): only
    where they are DTensors under an ambient mesh, else they are returned
    as they are.

    With a tensor-parallel context (`sharding.tp`) the block runs this
    rank's query heads on params holding its shards (`_project_qkv`; `wo`
    its rows, a row-parallel product): x enters through `copy_to_model`
    and the output leaves through `reduce_from_model`; the returned k/v
    are the rank's. A cross-attention's `kv` must already be inside the
    split (the caller sends the encoder output through `copy_to_model`
    once for every layer that reads it); its keys and values are the
    rank's kv heads' projections of it. With `all_kv` (the prefill, whose
    caches keep every kv head) a rank whose kv heads do not split projects
    all of them and returns them all, reading those its query heads read.
    """
    B, S, d = x.shape
    hd, nh = cfg.resolved_head_dim, cfg.n_heads
    kv_positions = positions if kv_positions is None else kv_positions
    if tp is not None:
        nh = tp.local_heads(cfg)
        x = TP.copy_to_model(x, tp)
    src = x if kv is None else kv
    q, k, v = _project_qkv(params, cfg, x, src, tp, all_kv)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    if constrain_kv:
        k = constrain(k, ("batch", None, None, "model"))
        v = constrain(v, ("batch", None, None, "model"))
    kr, vr = k, v
    if tp is not None and not tp.kv and all_kv:
        heads = tp.kv_heads(cfg)
        kr, vr = k[:, :, heads], v[:, :, heads]
    if cfg.attention_impl == "pallas" and kv is None and causal:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        out = fa_ops.flash_attention(q, kr, vr, causal=True, window=window)
    else:
        mask = _attn_mask(torch.broadcast_to(positions, (B, S)),
                          torch.broadcast_to(kv_positions, (B, src.shape[1])),
                          causal, window)
        out = _sdpa_xla(q, kr, vr, mask, 1.0 / math.sqrt(hd))
    out = out.reshape(B, S, nh * hd) @ params["wo"]
    if tp is not None:
        out = TP.reduce_from_model(out, tp)
    return out, (k, v)


def attention_decode(params, cfg, x, pos, cache_k, cache_v, cache_pos, *,
                     window=None, rope=True, rows=None, cross=False,
                     tp=None, split=False):
    """Single-token decode over a dense (ring) KV cache.

    x: (B, 1, d); pos: (B,) int32 absolute position of the new token;
    cache_k/cache_v: (B, Sc, nkv, hd); cache_pos: (B, Sc) int32 positions
    held in each cache slot (-1 = empty). Returns (out, cache_k, cache_v,
    cache_pos), the caches updated in place.

    The new token's k/v go to slot pos % Sc (a ring for windowed caches;
    for full caches Sc >= max_seq and slot = pos), but only for the batch
    rows in `rows` (a LongTensor of row indices; None = every row): rows
    left out keep their cache untouched, and their output is garbage the
    caller ignores. The read masks empty slots, positions after `pos` and,
    with a window, positions at or before pos - window; masked logits take
    finfo(f32).min, as in the reference. Cross-attention (`cross`) reads
    the cache only: nothing is written, and only empty slots are masked.

    With a tensor-parallel context (`sharding.tp`; `_attention_decode_tp`)
    params hold this rank's shards, and with `split` the caches hold this
    rank's slice of the sequence (`rules.cache_specs`).
    """
    if tp is not None:
        return _attention_decode_tp(params, cfg, x, pos, cache_k, cache_v,
                                    cache_pos, window=window, rope=rope,
                                    rows=rows, cross=cross, tp=tp,
                                    split=split)
    B = x.shape[0]
    hd, nh, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q, k_new, v_new = _decode_qkv(params, cfg, x, pos, rope, cross)
    if cross:
        valid = cache_pos >= 0
    else:
        valid = _write_token(cache_k, cache_v, cache_pos, k_new, v_new, pos,
                             rows, window)
    rep = nh // nkv
    qr = q.reshape(B, nkv, rep, hd)
    logits = torch.einsum("bkrh,bskh->bkrs", qr.float(),
                          cache_k.float()) * (1.0 / math.sqrt(hd))
    logits = logits.masked_fill(~valid[:, None, None, :],
                                torch.finfo(torch.float32).min)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrs,bskh->bkrh", w, cache_v.float())
    out = out.reshape(B, 1, nh * hd).to(x.dtype) @ params["wo"]
    return out, cache_k, cache_v, cache_pos


def _attention_decode_tp(params, cfg, x, pos, cache_k, cache_v, cache_pos,
                         *, window, rope, rows, cross, tp, split):
    """`attention_decode` over "model". Where the query heads split
    (`tp.heads`) wq, wo hold the rank's heads and wk/wv its kv heads (or
    every kv head, gathered, where those do not split: `tp.kv`); else
    every leaf is whole. With `split` cache_k/v/pos are the rank's slots
    [rank Sc/tp, (rank + 1) Sc/tp) of a cache of Sc: one all-reduce brings
    the token's queries (and keys and values where the kv heads split) to
    every rank, only the rank holding slot pos % Sc writes the new entry
    (rows in `rows` only), every rank reads all heads over its slots and
    the partials are merged (`tp.seq_split_read`, one all-reduce).
    Without `split` every rank holds the whole cache: it writes every kv
    head (gathered where they split) and reads its own heads. The rank's
    heads leave through its rows of wo (one all-reduce; none where the
    heads do not split). A cross read (`cross`) writes nothing."""
    B = x.shape[0]
    hd, nh, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    heads = tp.heads
    nh_l = tp.local_heads(cfg) if heads else nh
    q, k_new, v_new = _decode_qkv(params, cfg, x, pos, rope, cross,
                                  tp if heads else None)
    parts = [q] if heads and split else []
    kv_split = heads and tp.kv and not cross
    if kv_split:
        parts += [k_new, v_new]
    if parts:
        # one all-reduce: every rank's block of the token's q (k, v)
        sizes = [t.shape[2] * hd for t in parts]
        mine = torch.cat([t.reshape(B, -1) for t in parts], dim=-1)
        every = TP.gather_from_model(mine, tp, -1, False).reshape(
            B, tp.size, -1).split(sizes, dim=-1)
        every = [t.reshape(B, 1, -1, hd) for t in every]
        if heads and split:
            q_all = every.pop(0)
        if kv_split:
            k_new, v_new = every
    if cross:
        valid = cache_pos >= 0
    else:
        valid = _write_token(cache_k, cache_v, cache_pos, k_new, v_new, pos,
                             rows, window, tp.size if split else 1, tp.rank)
    scale = 1.0 / math.sqrt(hd)
    rep = nh // nkv
    if split:
        q_read = q_all if heads else q
        out = TP.seq_split_read(q_read.reshape(B, nkv, rep, hd).float(),
                                cache_k, cache_v, valid, scale, tp)
        out = out.reshape(B, nh, hd)
        if heads:
            out = tp.shard(out, 1)
    else:
        groups = tp.kv_heads(cfg) if heads else list(range(nkv))
        g0 = groups[0]
        if groups == list(range(g0, g0 + len(groups))):
            k_r = cache_k.narrow(2, g0, len(groups))
            v_r = cache_v.narrow(2, g0, len(groups))
        else:
            k_r, v_r = cache_k[:, :, groups], cache_v[:, :, groups]
        m, l, o = TP.read_partials(
            q.reshape(B, len(groups), -1, hd).float(), k_r, v_r, valid,
            scale)
        out = o / l[..., None]
    out = out.reshape(B, 1, nh_l * hd).to(x.dtype) @ params["wo"]
    if heads:
        out = TP.reduce_from_model(out, tp)
    return out, cache_k, cache_v, cache_pos


def _decode_qkv(params, cfg, x, pos, rope, cross, tp=None):
    """The decode token's q and, unless `cross`, its k_new and v_new
    (`_project_qkv`; with `tp`, every kv head where those do not split),
    roped at `pos`."""
    q, k, v = _project_qkv(params, cfg, x, None if cross else x, tp,
                           all_kv=True)
    if rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        if k is not None:
            k = apply_rope(k, pos[:, None], cfg.rope_theta)
    return q, k, v


def _write_token(cache_k, cache_v, cache_pos, k_new, v_new, pos, rows,
                 window, n_slices=1, index=0):
    """Write the token's k_new/v_new (B, 1, nkv, hd) and `pos` to slot
    pos % Sc, for the rows in `rows` (None = every row), and return the
    read's mask (B, slots): filled slots at or before `pos` and, with a
    window, after pos - window. The cache may be slice `index` of
    `n_slices` equal slices of a cache of Sc slots (its sequence split over
    "model"): only the slice holding the slot writes, the others write back
    what is there (fixed shapes)."""
    S = cache_k.shape[1]
    if rows is None:
        rows = torch.arange(pos.shape[0], device=pos.device)
    slot = (pos[rows] % (S * n_slices)).long()
    own = None
    if n_slices > 1:
        lo = index * S
        own = (slot >= lo) & (slot < lo + S)
        slot = (slot - lo).clamp(0, S - 1)
    for cache, new in ((cache_k, k_new[rows, 0]), (cache_v, v_new[rows, 0]),
                       (cache_pos, pos[rows])):
        new = new.to(cache.dtype)
        if own is not None:
            keep = own.reshape(-1, *([1] * (new.dim() - 1)))
            new = torch.where(keep, new, cache[rows, slot])
        cache.index_put_((rows, slot), new)
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])
    if window is not None:
        valid &= cache_pos > (pos[:, None] - window)
    return valid


def attention_decode_paged(params, cfg, x, pos, kpool, vpool, table, *,
                           window=None, rope=True, kernel="cuda"):
    """Single-token decode over a *paged* KV cache (block tables).

    x: (B, 1, d); pos: (B,) int32 absolute position of the new token.
    kpool/vpool: (P, bs, nkv, hd) — pool row b holds the bs-token KV page of
    block id b for this layer. table: (B, nb) int32 block ids per slot;
    page j of slot s holds positions [j*bs, (j+1)*bs). Returns
    (out, kpool, vpool); the pools are updated in place.

    Scatter: the new token's k/v land in pool row table[s, pos//bs] at
    offset pos % bs. Slots never share their frontier block (the engine's
    allocator guarantees it via copy-on-write). Inactive slots carry an
    all-zero table, so they all scatter into the reserved null block 0:
    those indices repeat, and torch leaves the winner of repeated writes
    undefined. That is harmless only because every read skips (kernel) or
    masks (reference) block 0 — keep that invariant.

    The attention read is kernel-switched (kernels/paged_attention):
    ``kernel="reference"`` gathers each slot's pages into a dense view;
    ``kernel="cuda"`` streams pages straight from the pool (the hand-
    written kernel on CUDA tensors, its plain version on CPU tensors;
    window must be None).
    """
    from repro_torch.kernels.paged_attention import ops as pa_ops
    B = x.shape[0]
    hd, nh = cfg.resolved_head_dim, cfg.n_heads
    bs = kpool.shape[1]
    with otrace.region("attn.proj") as rg:
        q, k_new, v_new = _project_qkv(params, cfg, x, x)
        if rope:
            q = apply_rope(q, pos[:, None], cfg.rope_theta)
            k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
        blk = torch.gather(table, 1, (pos // bs).long()[:, None])[:, 0].long()
        off = (pos % bs).long()
        kpool.index_put_((blk, off), k_new[:, 0])
        vpool.index_put_((blk, off), v_new[:, 0])
        rg.switch("attn.core")
        out = pa_ops.paged_attention(q[:, 0].contiguous(), kpool, vpool,
                                     table, pos, window=window, kernel=kernel)
        rg.switch("attn.proj")
        out = out.reshape(B, 1, nh * hd).to(x.dtype) @ params["wo"]
    return out, kpool, vpool


def attention_prefill_paged(params, cfg, x, q_pos, n_tok, kpool, vpool,
                            table, *, window=None, rope=True):
    """Suffix prefill over a paged cache: run `n_tok` real tokens (of the
    S=x.shape[1] bucketed batch, rest padding) whose absolute positions are
    `q_pos`, attending to everything already resident in this slot's pages
    (the reused prefix) plus themselves, and scatter their K/V into the
    pool in place. Single-sequence (B=1) — the engine prefills one slot at
    a time.

    x: (1, S, d); q_pos: (S,) absolute positions (start + arange(S));
    table: (nb,) this slot's block ids. Padded positions (index >= n_tok)
    scatter into null block 0 (repeated indices; see
    `attention_decode_paged`) and their outputs are garbage the caller
    ignores. Returns (out, kpool, vpool).
    """
    B, S, d = x.shape
    hd, nh, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    bs = kpool.shape[1]
    nb = table.shape[0]
    with otrace.region("attn.proj") as rg:
        q, k, v = _project_qkv(params, cfg, x, x)
        if rope:
            q = apply_rope(q, q_pos[None, :], cfg.rope_theta)
            k = apply_rope(k, q_pos[None, :], cfg.rope_theta)
        real = torch.arange(S, device=x.device) < n_tok
        # pad positions may run past the table (jnp.take fills there);
        # they go to block 0 either way
        page = (q_pos // bs).clamp(max=nb - 1).long()
        blk = torch.where(real, table[page], 0).long()
        off = torch.where(real, q_pos % bs, 0).long()
        kpool.index_put_((blk, off), k[0])
        vpool.index_put_((blk, off), v[0])
        rg.switch("attn.core")
        kall = kpool[table.long()].reshape(1, nb * bs, nkv, hd)
        vall = vpool[table.long()].reshape(1, nb * bs, nkv, hd)
        kv_pos = torch.arange(nb * bs, device=x.device)
        mask = kv_pos[None, :] <= q_pos[:, None]         # causal, absolute
        if window is not None:
            mask &= kv_pos[None, :] > (q_pos[:, None] - window)
        out = _sdpa_xla(q, kall, vall, mask[None], 1.0 / math.sqrt(hd))
        rg.switch("attn.proj")
        out = out.reshape(B, S, nh * hd) @ params["wo"]
    return out, kpool, vpool


def _gather_chain(pool, table):
    """The pages named by `table` (..., nb) as one dense run per row:
    (..., nb * bs, nkv, hd), index = absolute position."""
    g = pool[table.long()]
    return g.reshape(*table.shape[:-1], -1, *pool.shape[2:])


def attention_verify_paged(params, cfg, x, pos, kpool, vpool, table, *,
                           window=None, rope=True):
    """Multi-token batched decode over a paged cache, the speculative-
    decoding verify forward: slot s's T tokens sit at absolute positions
    pos[s] + [0, T); their K/V are scattered into the slot's pages first,
    then all T queries attend the whole chain, causal by absolute position
    (draft j sees the resident prefix plus drafts 0..j).

    x: (B, T, d); pos: (B,) int32; kpool/vpool: (P, bs, nkv, hd); table:
    (B, nb). Returns (out (B, T, d), kpool, vpool), the pools written in
    place. Positions past the table's span (a burst near the request's
    budget) scatter into null block 0, as do dead slots' all-zero rows
    (repeated indices; see `attention_decode_paged`); their outputs are
    garbage the caller's acceptance mask never reads. The read is the
    dense gather, as in the reference: no kernel is owed for it.
    """
    B, T, _ = x.shape
    hd, nh = cfg.resolved_head_dim, cfg.n_heads
    bs = kpool.shape[1]
    nb = table.shape[1]
    q, k, v = _project_qkv(params, cfg, x, x)
    q_pos = pos[:, None] + torch.arange(T, dtype=pos.dtype,
                                        device=x.device)[None, :]   # (B, T)
    if rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    in_span = q_pos < nb * bs
    page = (q_pos // bs).clamp(0, nb - 1).long()
    blk = torch.where(in_span, torch.gather(table, 1, page), 0).long()
    off = torch.where(in_span, q_pos % bs, 0).long()
    kpool.index_put_((blk, off), k)
    vpool.index_put_((blk, off), v)
    kv_pos = torch.arange(nb * bs, device=x.device)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]            # (B, T, Sk)
    if window is not None:
        mask &= kv_pos[None, None, :] > (q_pos[:, :, None] - window)
    mask &= (table != 0).repeat_interleave(bs, dim=1)[:, None, :]  # null pages
    out = _sdpa_xla(q, _gather_chain(kpool, table),
                    _gather_chain(vpool, table), mask, 1.0 / math.sqrt(hd))
    return out.reshape(B, T, nh * hd) @ params["wo"], kpool, vpool


def attention_mixed_paged(params, cfg, x, pos, n_chunk, kpool, vpool, table,
                          ctable, *, window=None, rope=True, kernel="cuda"):
    """Mixed decode + chunk attention over a paged cache in one pass, the
    per-layer unit of the chunked-prefill scheduler's mixed step.

    x: (1, B + C, d): the first B rows are one decode token per slot (B ==
    table.shape[0]), the last C one prompt's prefill chunk (right-padded;
    `n_chunk` of them real). pos: (B + C,) int32 absolute positions of
    every row. All rows' K/V are scattered in ONE combined pool write, then
    two reads run from the same pools:

      * decode rows attend their own chains through `table`, kernel-
        switched exactly like `attention_decode_paged` (the paged-attention
        kernel's second caller);
      * chunk rows attend the chunk slot's chain through `ctable`
        (truncated by the caller to the pages the chunk can causally see),
        causal by absolute position, by the dense gather (the contract of
        `attention_prefill_chunk_paged`, the chunk-only oracle).

    The decode slots and the chunk slot never share a frontier page (the
    copy-on-write guarantee), so the order of the two row groups' writes
    is irrelevant. Pad chunk rows and masked decode slots (all-zero table
    rows) scatter into null block 0. Returns (out (1, B + C, d), kpool,
    vpool), the pools written in place.
    """
    from repro_torch.kernels.paged_attention import ops as pa_ops
    R = x.shape[1]
    hd, nh = cfg.resolved_head_dim, cfg.n_heads
    bs = kpool.shape[1]
    B = table.shape[0]
    C = R - B
    nbc = ctable.shape[0]
    q, k, v = (t[0] for t in _project_qkv(params, cfg, x, x))  # (R, h, hd)
    if rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    # one combined scatter: decode rows land in their slots' frontier
    # pages, chunk rows in the chunk chain at their absolute offsets
    dec_blk = torch.gather(table, 1, (pos[:B] // bs).long()[:, None])[:, 0]
    cpos = pos[B:]
    real = (torch.arange(C, device=x.device) < n_chunk) & (cpos < nbc * bs)
    chk_blk = torch.where(real, ctable[(cpos // bs).clamp(0, nbc - 1).long()],
                          0)
    blk = torch.cat([dec_blk, chk_blk]).long()
    off = torch.cat([pos[:B] % bs, torch.where(real, cpos % bs, 0)]).long()
    kpool.index_put_((blk, off), k)
    vpool.index_put_((blk, off), v)
    # read 1: per-slot decode attention, kernel-switched
    out_dec = pa_ops.paged_attention(q[:B].contiguous(), kpool, vpool, table,
                                     pos[:B], window=window, kernel=kernel)
    # read 2: the chunk attends its truncated chain, causal by position
    kv_pos = torch.arange(nbc * bs, device=x.device)
    mask = kv_pos[None, :] <= cpos[:, None]
    if window is not None:
        mask &= kv_pos[None, :] > (cpos[:, None] - window)
    mask &= (ctable != 0).repeat_interleave(bs)[None, :]
    out_chk = _sdpa_xla(q[None, B:], _gather_chain(kpool, ctable)[None],
                        _gather_chain(vpool, ctable)[None], mask[None],
                        1.0 / math.sqrt(hd))[0]
    out = torch.cat([out_dec.reshape(B, nh * hd).to(x.dtype),
                     out_chk.reshape(C, nh * hd)])
    return (out @ params["wo"])[None], kpool, vpool


def attention_prefill_chunk_paged(params, cfg, x, start, n_tok, kpool, vpool,
                                  table, *, window=None, rope=True):
    """One bounded chunk of a prompt's prefill over a paged cache, the
    chunk half's oracle (the engine's mixed step fuses it with the
    lockstep decode, `attention_mixed_paged`; tests hold the two against
    each other).

    x: (1, S, d) with S == the chunk budget; the first `n_tok` rows are
    real tokens at absolute positions start..start+n_tok-1, the rest
    right-pad; table: (nb,) this slot's block ids. The chunk's K/V are
    scattered at their absolute offsets (pad rows and any position past
    the table's span into null block 0), then the chunk attends, causal by
    absolute position, everything resident below `start` plus itself;
    null pages never contribute keys. Returns (out (1, S, d), kpool,
    vpool), the pools written in place.
    """
    B, S, _ = x.shape
    hd, nh = cfg.resolved_head_dim, cfg.n_heads
    bs = kpool.shape[1]
    nb = table.shape[0]
    q, k, v = _project_qkv(params, cfg, x, x)
    q_pos = start + torch.arange(S, device=x.device)
    if rope:
        q = apply_rope(q, q_pos[None, :], cfg.rope_theta)
        k = apply_rope(k, q_pos[None, :], cfg.rope_theta)
    real = (torch.arange(S, device=x.device) < n_tok) & (q_pos < nb * bs)
    page = (q_pos // bs).clamp(0, nb - 1).long()
    blk = torch.where(real, table[page], 0).long()
    off = torch.where(real, q_pos % bs, 0).long()
    kpool.index_put_((blk, off), k[0])
    vpool.index_put_((blk, off), v[0])
    kv_pos = torch.arange(nb * bs, device=x.device)
    mask = kv_pos[None, :] <= q_pos[:, None]             # causal, absolute
    if window is not None:
        mask &= kv_pos[None, :] > (q_pos[:, None] - window)
    mask &= (table != 0).repeat_interleave(bs)[None, :]
    out = _sdpa_xla(q, _gather_chain(kpool, table)[None],
                    _gather_chain(vpool, table)[None], mask[None],
                    1.0 / math.sqrt(hd))
    return out.reshape(B, S, nh * hd) @ params["wo"], kpool, vpool


# ----------------------------------------------------------------------------- mlp

def init_mlp(gen, d_model, d_ff, dtype, gated=True):
    p = {
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp(params, x, act="silu", tp=None):
    """With a tensor-parallel context (`sharding.tp`) params hold this
    rank's FFN columns (w_gate/w_up) and rows (w_down): x enters through
    `copy_to_model`, the row-parallel output leaves through
    `reduce_from_model`."""
    if tp is not None:
        return TP.reduce_from_model(
            mlp(params, TP.copy_to_model(x, tp), act), tp)
    a = ACTIVATIONS[act]
    if "w_gate" in params:        # SwiGLU-style
        return (a(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]
    return a(x @ params["w_up"]) @ params["w_down"]


# ----------------------------------------------------------------------------- embed

def init_embedding(gen, vocab, d, dtype):
    t = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32) * 0.02
    return {"table": t.to(dtype)}


def embed(params, tokens, tp=None):
    """With a vocab-split context (`sharding.tp`) `table` is this rank's
    rows: `vocab_parallel_embed`."""
    if tp is not None:
        return TP.vocab_parallel_embed(params["table"], tokens, tp)
    return params["table"][tokens]


def unembed(params, x, tp=None):
    """With a vocab-split context the rank's (..., V/tp) logits (x enters
    through `copy_to_model`)."""
    if tp is not None:
        x = TP.copy_to_model(x, tp)
    return x @ params["table"].T
