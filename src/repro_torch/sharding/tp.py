"""Tensor parallelism over the mesh's "model" axis for every family (the
dense and MoE decoders, the encoder-decoder, the RG-LRU hybrid and
Mamba2): Megatron-LM's column/row split with explicit collectives, the
port's counterpart of GSPMD partitioning the reference's step over
"model".

A rank of the model axis computes only its share, in the layouts the rule
engine stores (`rules.param_specs`): its query heads (`wq`/`wk`/`wv`
columns, `wo` rows; in the encoder and the cross-attention too), its FFN
columns (`w_gate`/`w_up` columns, `w_down` rows), its experts or its
columns of every expert (below) and its vocabulary rows (`embed/table`
rows, `lm_head` columns). The residual stream stays whole on every rank.
Four operators carry it across the split, each an all-reduce over the
model group in one direction and the identity in the other:

  copy_to_model         identity forward, all-reduce backward: the input
                        of a column-parallel product
  reduce_from_model     all-reduce forward, identity backward: the output
                        of a row-parallel product
  vocab_parallel_embed  the rank's vocabulary rows looked up, the others
                        zero, then reduce_from_model
  vocab_parallel_xent   `train.losses.softmax_xent` over (..., V/tp) local
                        logits: the max (no gradient), the sum of exps and
                        the target logit each all-reduced (the mean over V
                        too under label smoothing); the full (..., V)
                        logits never exist

Two more serve the recurrent mixers:

  gather_from_model     a rank's channels (..., n) as the full (...,
                        n * tp): forward, the channels placed in a zeroed
                        buffer and all-reduced; backward, the full
                        gradient all-reduced and the rank's slice taken
                        (Megatron's all-gather, written with all_reduce;
                        also how the step gathers a leaf stored split
                        over "model" that it takes whole,
                        `spmd.split_params`)
  sum_over_model        all-reduce forward and backward: a sum whose
                        every summand feeds split compute afterwards (the
                        gated RMSNorm's sum of squares), so each rank's
                        gradient of it is only its own share

All of them use `all_reduce` alone (the one collective gloo also runs on
CUDA tensors). A split the heads, the FFN width or the vocabulary does not
divide falls back per part: the part's leaves are gathered and computed
whole on every rank (`TensorParallel.heads`/`.kv`/`.ffn`/`.vocab`); where
the query heads divide and the kv heads do not, `wk`/`wv` are gathered and
each rank projects the kv heads its query heads read. Storage keeps the
reference's specs in every case.

An MoE FFN (`models.moe`) splits by the reference's storage rule
(`TensorParallel.experts`): "expert" where the model axis divides the
padded experts (each rank holds Ep/tp whole experts and runs only its
experts' kept entries, in a (B, Ep/tp, C, d) buffer), "d_ff" where it
divides the expert width instead (each rank runs every expert's buffer
through its d_ff columns), else the experts run whole. The router, its
top-k, the capacity slots and the aux losses stay outside the split, on
the whole input, the same on every rank; the FFN's input and the gate
weights enter through `copy_to_model`, the mixed output leaves through
`reduce_from_model`. The rows are the same on every rank, so no
all-to-all is needed. An encoder-decoder's encoder output enters the
split once (`copy_to_model` before the decoder stack), and every
cross-attention projects its kv heads' keys and values from it.

An RG-LRU block (`models.rglru`, where the model axis divides
`lru_width`: `TensorParallel.lru`) runs its branches, depthwise conv and
scan on the rank's w/tp channels (`w_x`, `w_gate_branch`, `conv_w`
columns, the reference's storage split; the recurrence is per channel).
Its gates `w_r`/`w_i` are column-split too but contract over the whole
width, so the conv output is gathered for them (`gather_from_model`);
`out_proj` is row-split. The per-channel vectors (`conv_b`, `b_r`, `b_i`,
`Lambda`) are stored replicated and taken gathered, a rank reading its
slice.

A Mamba2 block (`models.mamba2`, where the model axis divides the SSM
heads: `TensorParallel.ssm`) runs its heads' channels: its z, x and dt
columns of `in_proj`, the B/C columns of the groups its heads read (all
of them for one group), the conv on those channels, the SSD on its heads,
and the gated RMSNorm with its sum of squares over the whole `d_inner`
(`sum_over_model`); `out_proj` is row-split (its rows are exactly the
rank's heads' channels). Unlike `wq`'s columns, the reference stores
`in_proj` and `conv_w` split by contiguous columns of the fused
[z | x | B | C | dt] and [x | B | C] layouts, which do not follow the
segments (on reduced mamba2, rank 0 of 2 holds z and 40 columns of x),
so both are taken gathered and sliced per segment on the rank: their
gradients are partial sums over "model", and the B/C columns' sums, to
which every rank contributes, are the cross-rank totals. The B/C
projection and conv run whole on every rank (no collective to share
them): the one replicated product of the split, d x 2 g n a token.

`in_scope` admits every layer type the port has; a part the axis does
not divide (the RG-LRU width, the SSM heads) runs whole on gathered
leaves, as the attention's do.

The serving steps (`serve.step.build_prefill` / `build_decode` with
`tp`, run by `spmd.call_split`) split the same way for every family. The
prefill is the training forward without its backward, and it emits
every kv head's keys and values on the rank that projects them (where
the kv heads do not divide, every rank projects all of them from the
gathered wk/wv). The decode caches hold the sequence over "model", as
the reference's flash-decoding layout (`rules.cache_specs`): a rank
holds slots [r Sc/tp, (r + 1) Sc/tp) of every kv head. A decode step
gathers the token's queries (and keys and values, where the kv heads
split) to every rank, the owner of slot pos % Sc writes the new entry,
every rank reads all heads over its slots (`read_partials`: an online
softmax's max, sum and unnormalised output), the ranks' partials are
gathered and merged (`combine_partials`), and each rank's heads go
through its rows of `wo`. A recurrent layer's state stays whole on
every rank, the reference's batch-only layout (`rules.cache_specs`): a
decode step cuts the rank's channels or heads out of it, steps them,
and makes the new state whole again by one all-reduce of the
zero-padded, packed state (`rglru.whole_state`, `mamba2.whole_state`;
a Mamba2 group's B/C window columns from one rank only,
`mamba2._rank_columns`), and the prefill gathers the state it emits the
same way. The greedy token over the vocabulary shards is the lowest
index of the global max (`vocab_parallel_argmax`). Every collective is
still an all-reduce, except the prefill caches' move from the rank's
heads to the reference's head_dim layout (`heads_to_head_dim`), an
all-to-all where the process group runs one on the tensors' device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import List, Optional

import torch

from repro_torch.sharding import rules as R

COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")    # split on dim 1; wo and
                                                 # w_down on dim 0
RGLRU_COLUMN = ("w_x", "w_gate_branch", "w_r", "w_i", "conv_w")  # dim 1
LAYER_TYPES = ("attn", "rglru", "ssm")


def in_scope(cfg) -> bool:
    """Families whose layers the split knows: attention (with a dense or
    an MoE FFN; a modality prefix only changes the inputs, an
    encoder-decoder's encoder layers are the dense decoder's), RG-LRU and
    Mamba2."""
    return all(t in LAYER_TYPES for t in cfg.layer_types())


def expert_split(cfg, size: int) -> Optional[str]:
    """How an MoE FFN splits over `size` model ranks, by the reference's
    storage rule (`rules.py`): "expert" where `size` divides the padded
    experts, "d_ff" where it divides the expert width, else None (the
    experts run whole)."""
    m = cfg.moe
    if m is None:
        return None
    if m.padded_n_experts % size == 0:
        return "expert"
    if m.expert_d_ff % size == 0:
        return "d_ff"
    return None


@dataclass
class TensorParallel:
    """The mesh, the size of its "model" axis, and which parts of the layer
    split (a part that does not divide is computed whole); the model group
    and this rank's place in it are read from the mesh when first used (a
    plan needs no process group). Counts the all-reduces its operators
    issue (`all_reduces`, `all_reduce_bytes`: forward and backward,
    recomputations included)."""
    mesh: object
    size: int
    heads: bool          # query heads (and wq, wo, q/k norms) split
    kv: bool             # kv heads split too (else wk/wv gathered)
    ffn: bool            # the dense FFN's columns split
    vocab: bool
    experts: Optional[str] = None    # MoE: "expert", "d_ff" or None
    lru: bool = False    # the RG-LRU width splits
    ssm: bool = False    # the Mamba2 heads split
    all_reduces: int = field(default=0)
    all_reduce_bytes: int = field(default=0)
    all_to_alls: int = field(default=0)

    @classmethod
    def build(cls, cfg, mesh) -> Optional["TensorParallel"]:
        """The context for `cfg` on `mesh`, or None where the step stays
        gathered: no "model" axis larger than 1, or an arch out of
        scope."""
        tp = R.mesh_axis_size(mesh, "model")
        if tp <= 1 or not in_scope(cfg):
            return None
        return cls(mesh=mesh, size=tp, heads=cfg.n_heads % tp == 0,
                   kv=cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0,
                   ffn=cfg.moe is None and cfg.d_ff % tp == 0,
                   vocab=cfg.padded_vocab_size % tp == 0,
                   experts=expert_split(cfg, tp),
                   lru=cfg.rglru is not None
                   and (cfg.rglru.lru_width or cfg.d_model) % tp == 0,
                   ssm=cfg.ssm is not None
                   and cfg.ssm.n_heads(cfg.d_model) % tp == 0)

    @cached_property
    def group(self):
        return self.mesh.get_group("model")

    @cached_property
    def rank(self) -> int:
        return self.mesh.get_local_rank("model")

    def part(self, name: str) -> Optional["TensorParallel"]:
        """self where `name` ("heads", "ffn", "vocab", "experts", "lru",
        "ssm") splits, else None (the part runs the one-device code on
        gathered leaves)."""
        return self if getattr(self, name) else None

    def all_reduce(self, x, op: str = "sum"):
        import torch.distributed._functional_collectives as funcol
        self.all_reduces += 1
        self.all_reduce_bytes += x.numel() * x.element_size()
        return funcol.wait_tensor(funcol.all_reduce(x, op, self.group))

    def all_to_all(self, x):
        """`x`'s dim-0 blocks exchanged over the model ranks: block j goes
        to rank j, and block i of the result came from rank i."""
        import torch.distributed._functional_collectives as funcol
        self.all_to_alls += 1
        return funcol.wait_tensor(
            funcol.all_to_all_single(x.contiguous(), None, None, self.group))

    def runs_all_to_all(self, x) -> bool:
        """Whether the model group runs an all-to-all on `x`'s device:
        gloo runs only all-reduce (and broadcast) on CUDA tensors."""
        import torch.distributed as dist
        return not (x.is_cuda and dist.get_backend(self.group) == "gloo")

    def shard(self, x, dim: int = -1):
        """This rank's 1/size of `x` along `dim`, a contiguous block (a
        view)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    # ------------------------------------------------------- attention

    def local_heads(self, cfg) -> int:
        return cfg.n_heads // self.size

    def local_experts(self, cfg) -> range:
        """The padded experts whose compute is this rank's: its Ep/tp
        where the experts split, else all of them."""
        ep = cfg.moe.padded_n_experts
        if self.experts != "expert":
            return range(ep)
        n = ep // self.size
        return range(self.rank * n, (self.rank + 1) * n)

    def kv_heads(self, cfg) -> List[int]:
        """The kv heads this rank's query heads read, in order, one entry
        per local kv group (GQA: query head h reads kv head h // rep):
        whole groups, one shared group, or one kv head per query head
        where the groups straddle ranks."""
        nh_l = self.local_heads(cfg)
        return head_groups(self.rank * nh_l, nh_l,
                           cfg.n_heads // cfg.n_kv_heads)

    # ------------------------------------------------------- leaf roles

    def role(self, path: tuple):
        """How the step takes the leaf at the port's `path`, and how its
        gradient lies over "model": ("shard", d) local shard, already its
        gradient's; ("partial",) gathered, used inside the head split (its
        gradient a partial sum over the model ranks); ("replicate",)
        gathered or replicated and used whole on every rank (the residual
        stream's norms, the MoE router, a part that does not split), the
        same gradient on every rank. The encoder's layers and the
        cross-attention take the decoder's roles. Of an RG-LRU block the
        column leaves are split as stored and `out_proj` by rows, its
        vectors partial; of a Mamba2 block `out_proj` is split by rows
        and every other leaf partial (`in_proj` and `conv_w` too: their
        stored split does not follow the segments)."""
        name = path[-2] if path[-1] == "scale" else path[-1]
        parent = path[-2] if len(path) >= 2 else None
        if name == "table":
            return ("shard", 0) if self.vocab else ("replicate",)
        if name == "lm_head":
            return ("shard", 1) if self.vocab else ("replicate",)
        if parent == "ffn" and self.experts is not None:
            if name == "router":
                return ("replicate",)
            if self.experts == "expert":
                return ("shard", 0)
            return ("shard", 1) if name == "w_down" else ("shard", 2)
        if parent in ("attn", "cross_attn") or name in ("q_norm", "k_norm"):
            if not self.heads:
                return ("replicate",)
            if name in ("wk", "wv") and not self.kv:
                return ("partial",)
            if name in ("q_norm", "k_norm"):
                return ("partial",)
            return ("shard", 1) if name in COLUMN else ("shard", 0)
        if parent == "ffn":
            if not self.ffn:
                return ("replicate",)
            return ("shard", 1) if name in COLUMN else ("shard", 0)
        if parent in ("rglru", "mamba"):
            if not (self.lru if parent == "rglru" else self.ssm):
                return ("replicate",)
            if name == "out_proj":
                return ("shard", 0)
            if parent == "rglru" and name in RGLRU_COLUMN:
                return ("shard", 1)
            return ("partial",)
        return ("replicate",)


def head_groups(first: int, n_local: int, rep: int) -> List[int]:
    """The groups (of `rep` consecutive heads each) that heads first ..
    first + n_local - 1 read, one entry per local group as the callers
    index them: whole groups in order, the one group they share, or one
    group per head where the groups straddle the ranks."""
    if n_local % rep == 0:
        return list(range(first // rep, (first + n_local) // rep))
    if rep % n_local == 0:
        return [first // rep]
    return [(first + j) // rep for j in range(n_local)]


# ------------------------------------------------------------ operators

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.contiguous()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim, partial):
        ctx.tp, ctx.dim, ctx.partial = tp, dim, partial
        shape = list(x.shape)
        shape[dim] *= tp.size
        full = x.new_zeros(shape)
        tp.shard(full, dim).copy_(x)
        return tp.all_reduce(full)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        if ctx.partial:
            g = tp.all_reduce(g.contiguous())
        return tp.shard(g, ctx.dim).contiguous(), None, None, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.contiguous()), None


def copy_to_model(x, tp: TensorParallel):
    """Identity forward, all-reduce backward (Megatron's f)."""
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x, tp: TensorParallel):
    """All-reduce forward, identity backward (Megatron's g)."""
    return _ReduceFromModel.apply(x, tp)


def gather_from_model(x, tp: TensorParallel, dim: int = -1,
                      partial: bool = True):
    """This rank's block of `dim` (the rank-th of tp equal blocks) as the
    whole over the model ranks (Megatron's all-gather): all-reduce of the
    zero-padded block forward; backward, the rank's slice of the
    gradient, all-reduced first where it is `partial` (each rank's
    products read the whole, so each holds a share of its gradient), not
    where every rank's gradient is the whole one."""
    return _GatherFromModel.apply(x, tp, dim, partial)


def sum_over_model(x, tp: TensorParallel):
    """The sum of `x` over the model ranks, all-reduced forward and
    backward: the summands' gradients lie on every rank, each rank's
    result feeding only its own split compute."""
    return _SumOverModel.apply(x, tp)


def _vocab_local(ids, rows: int, tp: TensorParallel):
    """(ids as indices into this rank's `rows` vocabulary rows, clamped,
    and the mask of the ids it owns)."""
    local = ids.long() - tp.rank * rows
    own = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), own


def vocab_parallel_embed(table, tokens, tp: TensorParallel):
    """`table[tokens]` with `table` this rank's (V/tp, d) rows: the rows
    it owns looked up, the others zero, summed over the model ranks."""
    idx, own = _vocab_local(tokens, table.shape[0], tp)
    x = table[idx].masked_fill(~own[..., None], 0)
    return reduce_from_model(x, tp)


def vocab_parallel_xent(logits, labels, mask=None,
                        label_smoothing: float = 0.0, *, tp: TensorParallel):
    """`softmax_xent` of the full logits, given this rank's (..., V/tp)
    slice of them: the same mean token cross-entropy in float32, the mask's
    denominator and the smoothing's mean over the whole (padded)
    vocabulary included. Every rank returns the same value."""
    logits = logits.float()
    rows = logits.shape[-1]
    with torch.no_grad():
        m = tp.all_reduce(logits.amax(dim=-1), "max")
    sumexp = reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1),
                               tp)
    lse = m + torch.log(sumexp)
    idx, own = _vocab_local(labels, rows, tp)
    ll = torch.gather(logits, -1, idx[..., None])[..., 0]
    ll = reduce_from_model(ll.masked_fill(~own, 0), tp)
    nll = lse - ll
    if label_smoothing > 0:
        mean = reduce_from_model(logits.sum(dim=-1), tp) / (rows * tp.size)
        nll = (1 - label_smoothing) * nll + label_smoothing * (lse - mean)
    if mask is not None:
        denom = torch.clamp(mask.sum(), min=1.0)
        return (nll * mask).sum() / denom
    return nll.mean()


def leaf_gather_all_reduces(cfg, params, mesh, tp: TensorParallel,
                            backward: bool = True) -> int:
    """The all-reduces a microbatch of the tensor-parallel step spends on
    the leaves stored split over "model" that it takes whole
    (`spmd.split_params`): two for a leaf used inside the split (its
    gather, its gradient's reduction), one for a leaf every rank uses
    whole (its gather). Without a `backward` (a serving step,
    `spmd.call_split`) one for each such leaf."""
    specs = R.spec_leaves(R.param_specs(cfg, params, mesh))
    n = 0
    for path, spec in zip(R.leaf_paths(params), specs):
        role = tp.role(path)[0]
        if role != "shard" and any(
                e == "model" or (isinstance(e, tuple) and "model" in e)
                for e in spec):
            n += 2 if role == "partial" and backward else 1
    return n


def gathered_leaves(cfg, params, mesh, tp: Optional[TensorParallel]):
    """The reference paths (blocks stacked, `rules.reference_path`) of the
    leaves stored split over "model" whose compute is gathered: every such
    leaf without tensor parallelism, else those of the parts that do not
    split. In tree order, each path once."""
    specs = R.spec_leaves(R.param_specs(cfg, params, mesh))
    out = []
    for path, spec in zip(R.leaf_paths(params), specs):
        if not any(e == "model" or (isinstance(e, tuple) and "model" in e)
                   for e in spec):
            continue
        if tp is not None and tp.role(path)[0] == "shard":
            continue
        name = R.reference_path(path, cfg)[0]
        if name not in out:
            out.append(name)
    return out


# ------------------------------------------------------------ serving

NEG = torch.finfo(torch.float32).min    # the reference's masked logit


def cache_split(c_specs) -> tuple:
    """(self, cross): whether the self-attention and the cross-attention
    decode caches of `c_specs` (`rules.cache_specs`) hold the sequence
    split over "model"; a length the axis does not divide stays whole."""
    def split(name):
        return any(name in layer and layer[name][1] == "model"
                   for layer in c_specs)
    return split("k"), split("cross_k")


def read_partials(q, k, v, valid, scale: float):
    """The partials of a decode read over one slice of the cache, as an
    online softmax keeps them, in float32: q (B, nkv, rep, hd) (float32),
    k/v (B, s, nkv, hd), valid (B, s) -> m, l (B, nkv, rep), o (B, nkv,
    rep, hd): the max of the masked logits (masked ones take finfo(f32).min
    as in the reference, so a slice with every slot masked has m = that
    minimum and adds nothing beside any other), the sum of exp(logit - m)
    and the unnormalised output."""
    logits = torch.einsum("bkrh,bskh->bkrs", q, k.float()) * scale
    logits = logits.masked_fill(~valid[:, None, None, :], NEG)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bkrs,bskh->bkrh", p,
                                          v.float())


def combine_partials(m, l, o):
    """The read over every slice from the slices' partials stacked on a
    leading dim: o = sum_r e^(m_r - M) o_r / sum_r e^(m_r - M) l_r, with M
    the max over the slices."""
    w = torch.exp(m - m.amax(dim=0))
    return (w[..., None] * o).sum(dim=0) / (w * l).sum(dim=0)[..., None]


def seq_split_read(q, k, v, valid, scale: float, tp: TensorParallel):
    """The decode read of every head over the cache whose sequence the
    model ranks split: this rank's partials over its slots
    (`read_partials`), gathered over the ranks (one all-reduce of the
    zero-padded (m, l, o)) and merged (`combine_partials`). Returns (B,
    nkv, rep, hd) float32, the same on every rank."""
    m, l, o = read_partials(q, k, v, valid, scale)
    packed = torch.cat([m[..., None], l[..., None], o], dim=-1)
    every = gather_from_model(packed[None], tp, 0, False)
    return combine_partials(every[..., 0], every[..., 1], every[..., 2:])


def vocab_parallel_argmax(logits, tp: TensorParallel):
    """torch.argmax over the full vocabulary, given this rank's (..., V/tp)
    slice of the logits: each rank's (max, argmax + its offset) gathered
    (one all-reduce), the lowest index of the global max taken (a tie goes
    to the lower index, as torch.argmax and jnp.argmax break it; padded
    rows hold -1e30, `transformer._logits`, and never win). int32."""
    rows = logits.shape[-1]
    i = torch.argmax(logits, dim=-1, keepdim=True)
    m = torch.gather(logits, -1, i)[..., 0].double()
    cand = torch.stack([m, (i[..., 0] + tp.rank * rows).double()], dim=-1)
    every = gather_from_model(cand[None], tp, 0, False)
    best = torch.argmax(every[..., 0], dim=0, keepdim=True)
    return torch.gather(every[..., 1], 0, best)[0].to(torch.int32)


def heads_to_head_dim(x, tp: TensorParallel, all_to_all: bool):
    """(b, s, n/tp, hd): this rank's heads -> (b, s, n, hd/tp): its
    head_dim slice of every head (the reference's prefill-cache layout).
    An all-to-all of the head_dim blocks; with `all_to_all` False the
    heads are gathered (one all-reduce of the zero-padded (b, s, n, hd))
    and sliced."""
    if not all_to_all:
        return tp.shard(gather_from_model(x, tp, 2, False), 3).contiguous()
    b, s, h, hd = x.shape
    t = tp.size
    send = x.reshape(b, s, h, t, hd // t).permute(3, 0, 1, 2, 4)
    got = tp.all_to_all(send)                    # (t, b, s, h, hd / t)
    return got.permute(1, 2, 0, 3, 4).reshape(b, s, t * h, hd // t)


def prefill_local_specs(out_specs, tp: TensorParallel):
    """How `serve.step.build_prefill(cfg, tp=tp)`'s outputs lie on a rank,
    for `spmd.call_split`, given their layout `out_specs` (token, caches
    by `rules.prefill_cache_specs`): each k/v (and cross k/v) holds the
    rank's kv heads (dim 2 over "model") where the kv heads split, else
    every kv head; the rest as `out_specs`."""
    tok, caches = out_specs
    heads = tp.heads and tp.kv

    def local(name, spec):
        if name not in ("k", "v", "cross_k", "cross_v"):
            return spec
        dims = list(spec)
        dims[-1] = None
        dims[2] = "model" if heads else None
        return R.P(*dims)
    return tok, [{k: local(k, s) for k, s in layer.items()}
                 for layer in caches]
