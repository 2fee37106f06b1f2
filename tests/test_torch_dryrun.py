"""The port's dry-run (`repro_torch.launch.dryrun`): every step run on
fake tensors as rank 0 of a fake process group, with torch's flop,
collective and memory counters, and the CLI on full configs on the debug
meshes (the reference's tests/test_sharding_rules.py reduced cases and
tests/test_dryrun_small.py CLI cases). `constrain` on a fake (2, 2) mesh.

Flops: the mesh step is data parallel over "pod" x "data". A train step
is tensor parallel over "model" (`sharding.tp`; every family): each rank
computes its heads, FFN columns or experts, RG-LRU channels or Mamba2
heads, and vocabulary rows, so a case's per-device flops times the ranks
equal the one-rank count of the same step plus what the model ranks
repeat, within 1% (FlopCounterMode counts products only). They repeat
the kv projections where the kv heads do not divide the axis (each rank
projects the kv heads its query heads read: recurrentgemma's one),
Mamba2's B/C projection (one group, read by every head), the MoE router,
and a part the axis does not divide, whole (measured on reduced configs:
the dense decoders and seamless equal, granite-moe 0.08%, recurrentgemma
1.5% and mamba2 3.1% above the one-rank count, each exactly its repeated
products: the residual is 0). The serving steps of every family run
tensor parallel too (`spmd.call_split`, the decode caches' sequence over
"model", a recurrent state whole on every rank): flops times ranks equal
the one-rank count plus what the model ranks repeat (the MoE router; the
kv projections where the kv heads do not divide the axis:
recurrentgemma's one; Mamba2's B/C projection and, in a decode step, its
conv on the B/C channels; a part the axis does not divide, whole),
within 1% (measured on reduced configs: recurrentgemma 1.5%, mamba2
3.1-3.3% above the one-rank count, each exactly its repeated products).
Serving all-reduces over "model": a decode step 4 an attention layer
(the token's q/k/v gathered, the partials merged, the attention output,
the FFN's or MoE's output), 7 a decoder layer with cross-attention, 4
an RG-LRU layer (its conv output's gather, its output, the MLP's output,
the new state's gather), 3 a Mamba2 layer (the norm's sum of squares,
its output, the new state's gather), one for the embedding and one for
the greedy token; a prefill 2 an attention layer (3 with
cross-attention, 2 an encoder layer), 4 an RG-LRU and 3 a Mamba2 layer
as in decode, the embedding's and the greedy token's, and 2
all-to-alls an attention layer (4 with cross-attention) moving the
caches' kv heads to head_dim where the kv heads split; one for each
leaf stored split over "model" and taken whole; no all-gather. The
tensor-parallel train step's all-reduces over "model",
per microbatch: 4 per dense layer (two forward, two backward), 5 per MoE
layer (the attention's 2; the experts' output forward, their input and
the gate weights backward), 6 per encoder-decoder decoder layer (the
cross-attention adds its output forward and its query's input
backward), 1 for the encoder output (its keys' and values' input, once
for all cross-attentions), 6 per RG-LRU layer (the mixer's input
backward, its conv output's gather forward and backward, its output
forward; the MLP's 2), 4 per Mamba2 layer (its input backward, the
norm's sum of squares forward and backward, its output forward), one for
the embedding and four for the logits and the loss (the max, the sum of
exps, the target logit, and the logits' input in the backward), and two
for each leaf stored split over "model" that the step takes whole (its
gather and its gradient's reduction: the gathered kv heads' wk/wv,
Mamba2's in_proj and conv_w).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from _torch_host import one_torch_thread  # noqa: F401
from repro_torch.configs import registry
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as M
from repro_torch.launch import shapes as S
from repro_torch.sharding import rules as R
from repro_torch.sharding import tp as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOPS_REL = 0.01
ARCHS = ["qwen3-1.7b", "granite-moe-1b-a400m", "mamba2-130m",
         "recurrentgemma-9b", "seamless-m4t-large-v2"]


@pytest.fixture(scope="module")
def debug_mesh():
    """The (2, 2) debug mesh on a fake process group of 4 ranks."""
    DR.fake_group(4)
    yield M.make_debug_mesh(device_type="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def small(monkeypatch):
    for name, c in list(S.SHAPES.items()):
        monkeypatch.setitem(S.SHAPES, name,
                            S.ShapeCase(c.name, c.kind, 64, 8))


def reduced(arch, shape):
    return registry.get(arch, reduced=True).replace(
        window=None if shape == "train_4k" else 16)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_case_runs_on_debug_mesh(debug_mesh, small, arch, shape):
    kind = S.SHAPES[shape].kind
    case, m = DR.measure_case(reduced(arch, shape), shape, debug_mesh,
                              microbatches=2 if kind == "train" else None)
    assert m["flops"] > 0
    assert m["memory"]["peak_bytes"] > 0
    colls = m["colls"]
    assert set(DR.COLLECTIVES) <= set(colls)
    # tensor parallel, every family and shape: all-reduces only
    assert case["tp"] is not None
    assert colls["all-reduce"]["count"] >= \
        m["model_axis_all_reduces"]["count"] > 0
    if kind != "train":
        assert colls["all-gather"]["count"] == 0
    if kind == "train":
        assert colls["all-reduce"]["count"] >= 1     # the gradients
        assert colls["all-reduce"]["bytes"] > 0


def one_rank_flops(cfg, shape, microbatches):
    """The same step without a mesh, on fake tensors, the global batch.
    Its MoE runs the GShard buffer path, which the tensor-parallel experts
    split (a decode group on one device would take the grouped experts:
    `moe.grouped`)."""
    from unittest import mock

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import moe
    case = S.make_case(cfg, shape, R.mesh_like((1,), ("data",)),
                       microbatches=microbatches)
    with FakeTensorMode(allow_non_fake_inputs=True), \
            mock.patch.object(moe, "grouped", lambda *a, **k: False):
        args = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype)
                        if isinstance(x, torch.Tensor) and x.is_meta else x,
                        case["args"])
        with FlopCounterMode(display=False) as fc:
            if S.SHAPES[shape].kind == "train":
                case["fn"](*args)
            else:
                with torch.no_grad():
                    case["fn"](*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_flops_per_device_times_ranks_is_one_rank_times_replication(
        debug_mesh, small, shape):
    """qwen3-1.7b: tensor parallel in training and serving, so the model
    axis replicates nothing (a replication of 1)."""
    cfg = reduced("qwen3-1.7b", shape)
    train = S.SHAPES[shape].kind == "train"
    mb = 2 if train else None
    case, m = DR.measure_case(cfg, shape, debug_mesh, microbatches=mb)
    assert case["tp"] is not None
    one = one_rank_flops(cfg, shape, mb)
    assert abs(m["flops"] * debug_mesh.size() - one) <= FLOPS_REL * one


SERVE_ARCHS = ["qwen3-1.7b", "qwen3-4b", "mistral-nemo-12b", "starcoder2-7b",
               "pixtral-12b", "granite-moe-1b-a400m", "granite-moe-3b-a800m",
               "seamless-m4t-large-v2"]


def serve_repeated_flops(cfg, mesh, shape) -> int:
    """The flops of a serving step that the model ranks repeat beyond
    their 1/tp shares, summed over the ranks (2 a multiply-add): the MoE
    router on every token, whole on every rank; where the kv heads do
    not divide the axis the kv projections: every rank projects all kv
    heads for the caches (a prefill's cross-attention too, over the
    encoder frames), and the kv heads its query heads read in the
    encoder's self-attention, as in training; where the Mamba2 heads
    split, the B/C projection of the groups each rank's heads read and,
    in a decode step, the conv on those channels (an einsum over the
    window; the prefill's conv is elementwise, no product)."""
    ctx = TP.TensorParallel.build(cfg, mesh)
    c = S.SHAPES[shape]
    prefill = c.kind == "prefill"
    tokens = c.global_batch * (c.seq_len if prefill else 1)
    if prefill and cfg.is_encdec:
        tokens //= 2
    n_attn = cfg.layer_types().count("attn")
    kv = 0 if ctx.kv else 2 * cfg.n_kv_heads * cfg.resolved_head_dim
    per_token = n_attn * ((ctx.size - 1) * kv + (
        (ctx.size - 1) * cfg.moe.n_experts if cfg.moe else 0))
    frames = tokens if prefill and cfg.is_encdec else 0
    enc = 0 if ctx.kv else (ctx.size * len(ctx.kv_heads(cfg))
                            - cfg.n_kv_heads) * cfg.resolved_head_dim * 2
    cross = cfg.n_layers * (ctx.size - 1) * kv + cfg.n_enc_layers * enc
    bc = 0
    if ctx.ssm:
        s = cfg.ssm
        nh = s.n_heads(cfg.d_model)
        mine = len(TP.head_groups(0, nh // ctx.size, nh // s.n_groups))
        bc = cfg.layer_types().count("ssm") * (
            ctx.size * mine - s.n_groups) * s.d_state * 2 * (
                cfg.d_model + (0 if prefill else s.d_conv))
    return 2 * cfg.d_model * (tokens * per_token + frames * cross) \
        + 2 * tokens * bc


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_flops_times_ranks_is_one_rank_plus_repeated(
        debug_mesh, small, arch, shape):
    """The eight attention archs' serving steps split over "model": flops x
    ranks = one rank + `serve_repeated_flops` (the MoE router here; the
    reduced configs' 2 kv heads divide the axis of 2)."""
    cfg = reduced(arch, shape)
    case, m = DR.measure_case(cfg, shape, debug_mesh)
    assert case["tp"] is not None
    one = one_rank_flops(cfg, shape, None)
    want = one + serve_repeated_flops(cfg, debug_mesh, shape)
    assert abs(m["flops"] * debug_mesh.size() - want) <= FLOPS_REL * one


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "seamless-m4t-large-v2"])
def test_gathered_kv_serving_flops_times_ranks_is_one_rank_plus_repeated(
        debug_mesh, small, arch, shape):
    """One kv head, which the model axis of 2 does not divide: wk and wv
    are gathered and every rank projects the kv head (the prefill's cross
    keys and values over the encoder frames too); each gathered leaf is
    one more all-reduce."""
    cfg = reduced(arch, shape).replace(n_kv_heads=1)
    case, m = DR.measure_case(cfg, shape, debug_mesh)
    assert case["tp"] is not None and not case["tp"].kv
    one = one_rank_flops(cfg, shape, None)
    want = one + serve_repeated_flops(cfg, debug_mesh, shape)
    assert want > one
    assert abs(m["flops"] * debug_mesh.size() - want) <= FLOPS_REL * one
    gathered = TP.leaf_gather_all_reduces(cfg, S.params_shapes(cfg),
                                          debug_mesh, case["tp"],
                                          backward=False)
    attns = cfg.n_layers * (2 if cfg.is_encdec else 1) + (
        cfg.n_enc_layers if cfg.is_encdec else 0)
    assert gathered == 2 * attns
    assert len(case["gathered_leaves"]) == 2 * (1 + 2 * cfg.is_encdec)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m"])
def test_recurrent_serving_flops_times_ranks_is_one_rank_plus_repeated(
        debug_mesh, small, arch, shape):
    """The recurrent families' serving steps split over "model": each rank
    steps its RG-LRU channels or Mamba2 heads of the whole state. Flops x
    ranks = one rank + `serve_repeated_flops`: recurrentgemma's one kv
    head (projected on both ranks), Mamba2's B/C projection (one group,
    read by every head) and its decode conv on those channels."""
    cfg = reduced(arch, shape)
    case, m = DR.measure_case(cfg, shape, debug_mesh)
    assert case["tp"] is not None and (case["tp"].lru or case["tp"].ssm)
    one = one_rank_flops(cfg, shape, None)
    want = one + serve_repeated_flops(cfg, debug_mesh, shape)
    assert want > one
    assert abs(m["flops"] * debug_mesh.size() - want) <= FLOPS_REL * one


def whole_serving_flops(cfg, shape, one) -> int:
    """A serving step's flops of the part `gathered_part_config` leaves
    whole (2 a multiply-add and token): every Mamba2 layer's, the
    one-rank count `one` less the tied logits' (every position's in a
    prefill), or the RG-LRU layers' five products and, in a decode step,
    their conv (an einsum over the window)."""
    c = S.SHAPES[shape]
    prefill = c.kind == "prefill"
    tokens = c.global_batch * (c.seq_len if prefill else 1)
    d = cfg.d_model
    if cfg.ssm:
        return one - 2 * tokens * d * cfg.padded_vocab_size
    w, k = cfg.rglru.lru_width, cfg.rglru.d_conv
    n = cfg.layer_types().count("rglru")
    return 2 * tokens * n * (3 * d * w + 2 * w * w + (0 if prefill
                                                      else k * w))


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m"])
def test_recurrent_serving_flops_times_ranks_is_one_rank_times_replication(
        debug_mesh, small, arch, shape):
    """A part the model axis does not divide (15 SSM heads, an RG-LRU
    width of 255 on 2 ranks) serves whole on gathered leaves and its
    whole state, with no state gather: every rank of the model axis
    repeats its compute (the replication), the rest splits."""
    cfg = gathered_part_config(arch, shape)
    case, m = DR.measure_case(cfg, shape, debug_mesh)
    tp = case["tp"]
    assert tp is not None and not tp.ssm and not tp.lru
    one = one_rank_flops(cfg, shape, None)
    replication = R.mesh_axis_size(debug_mesh, "model")
    want = one + serve_repeated_flops(cfg, debug_mesh, shape) + (
        replication - 1) * whole_serving_flops(cfg, shape, one)
    assert abs(m["flops"] * debug_mesh.size() - want) <= FLOPS_REL * one
    # no state gather: of a whole RG-LRU layer only its MLP's output
    assert m["model_axis_all_reduces"]["count"] == \
        serve_all_reduces(cfg, shape, tp, debug_mesh)


def serve_all_reduces(cfg, shape, tp, mesh) -> int:
    """A serving step's all-reduces over "model" (the module docstring):
    an attention layer 4 in a decode step, 2 in a prefill; an RG-LRU
    layer 4 (its gather, its output, the MLP's, the state's), a Mamba2
    layer 3 (the norm, its output, the state), where their part splits;
    else the MLP's alone (1) or none; 2 (the embedding, the greedy token)
    and one for each leaf stored split and taken whole."""
    types = cfg.layer_types()
    attn = 4 if S.SHAPES[shape].kind == "decode" else 2
    rglru = 4 if tp.lru else 1
    ssm = 3 if tp.ssm else 0
    return attn * types.count("attn") + rglru * types.count("rglru") \
        + ssm * types.count("ssm") + 2 + TP.leaf_gather_all_reduces(
            cfg, S.params_shapes(cfg), mesh, tp, backward=False)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m"])
def test_recurrent_serving_model_axis_all_reduces(debug_mesh, small, arch,
                                                  shape):
    """recurrentgemma (r, r, a): 4 + 4 + 2 + 2 + 2 = 14 a prefill, 4 + 4 +
    4 + 2 + 2 = 16 a decode step (its gathered wk and wv one each); mamba2
    (2 layers): 3 x 2 + 2 + 4 = 12 either way (each layer's in_proj and
    conv_w, stored split by contiguous columns, gathered); no all-to-all
    (the one kv head is projected whole on every rank and sliced to
    head_dim) and no all-gather."""
    cfg = reduced(arch, shape)
    case, m = DR.measure_case(cfg, shape, debug_mesh)
    want = {("recurrentgemma-9b", "prefill"): 14,
            ("recurrentgemma-9b", "decode"): 16,
            ("mamba2-130m", "prefill"): 12,
            ("mamba2-130m", "decode"): 12}[arch, S.SHAPES[shape].kind]
    assert serve_all_reduces(cfg, shape, case["tp"], debug_mesh) == want
    assert m["model_axis_all_reduces"]["count"] == want
    assert m["colls"]["all-reduce"]["count"] == want
    assert case["tp"].all_to_alls == 0
    assert m["colls"]["all-to-all"]["count"] == 0
    assert m["colls"]["all-gather"]["count"] == 0


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "seamless-m4t-large-v2"])
def test_serving_model_axis_all_reduces(debug_mesh, small, arch, shape):
    """A decode step: 4 a layer (7 with cross-attention) + 2; a prefill:
    2 a layer (3 with cross-attention, 2 an encoder layer) + 2, and the
    caches' all-to-alls, 2 a layer (4 with cross-attention); no
    all-gather (the step gathers nothing whole)."""
    cfg = reduced(arch, shape)
    case, m = DR.measure_case(cfg, shape, debug_mesh)
    L, c = cfg.n_layers, int(cfg.is_encdec)
    Le = cfg.n_enc_layers if c else 0
    if S.SHAPES[shape].kind == "decode":
        want, moves = (4 + 3 * c) * L + 2, 0
    else:
        want, moves = (2 + c) * L + 2 * Le + 2, 2 * (1 + c) * L
    assert m["model_axis_all_reduces"]["count"] == want
    assert case["tp"].all_to_alls == moves
    assert m["colls"]["all-to-all"]["count"] == moves
    assert m["colls"]["all-gather"]["count"] == 0
    assert m["colls"]["all-reduce"]["count"] == want


def repeated_flops(cfg, mesh, tokens) -> int:
    """The flops of a train step on `tokens` tokens that the model ranks
    repeat beyond their 1/tp shares, summed over the ranks: the kv
    projections where the query heads split and the kv heads do not
    (each rank projects the kv heads its query heads read), the MoE
    router (whole on every rank) and Mamba2's B/C projection where its
    heads split (each rank projects the groups its heads read). 6 flops a
    multiply-add and token: the forward product and the backward's
    two."""
    ctx = TP.TensorParallel.build(cfg, mesh)
    tp, d, cols = ctx.size, cfg.d_model, 0
    for t in cfg.layer_types():
        if t == "attn" and ctx.heads and not ctx.kv:
            cols += (tp * len(ctx.kv_heads(cfg)) - cfg.n_kv_heads) \
                * cfg.resolved_head_dim * 2
        if t == "attn" and cfg.moe:
            cols += (tp - 1) * cfg.moe.n_experts
        if t == "ssm" and ctx.ssm:
            s = cfg.ssm
            nh = s.n_heads(d)
            mine = len(TP.head_groups(0, nh // tp, nh // s.n_groups))
            cols += (tp * mine - s.n_groups) * s.d_state * 2
    return 6 * tokens * d * cols


@pytest.mark.parametrize("arch", ["starcoder2-7b", "pixtral-12b",
                                  "granite-moe-1b-a400m",
                                  "seamless-m4t-large-v2",
                                  "recurrentgemma-9b", "mamba2-130m"])
def test_tensor_parallel_train_flops_times_ranks_is_one_rank(
        debug_mesh, small, arch):
    """Plus what the ranks repeat (`repeated_flops`): nothing for the
    dense decoders and seamless, the router for granite-moe (0.08%),
    recurrentgemma's one kv head (1.5%) and mamba2's B/C projection
    (3.1%) on every rank."""
    cfg = reduced(arch, "train_4k")
    case, m = DR.measure_case(cfg, "train_4k", debug_mesh, microbatches=2)
    assert case["tp"] is not None
    one = one_rank_flops(cfg, "train_4k", 2)
    c = S.SHAPES["train_4k"]
    want = one + repeated_flops(cfg, debug_mesh, c.global_batch * c.seq_len)
    assert abs(m["flops"] * debug_mesh.size() - want) <= FLOPS_REL * one


def gathered_part_config(arch, shape="train_4k"):
    """Reduced mamba2 with 15 SSM heads (d_model 240) or reduced
    recurrentgemma with an RG-LRU width of 255: the model axis of 2
    divides neither, so that part runs whole on every model rank."""
    cfg = reduced(arch, shape)
    if cfg.ssm:
        return cfg.replace(d_model=240)
    return cfg.replace(rglru=dataclasses.replace(cfg.rglru, lru_width=255))


def whole_part_flops(cfg, tokens, one) -> int:
    """A train step's flops of the part `gathered_part_config` leaves
    whole (6 a multiply-add and token): every Mamba2 layer's, the
    one-rank count `one` less the tied logits' (the embedding lookup and
    the loss count none), or the RG-LRU layers' five products."""
    d = cfg.d_model
    if cfg.ssm:
        return one - 6 * tokens * d * cfg.padded_vocab_size
    w = cfg.rglru.lru_width
    n = cfg.layer_types().count("rglru")
    return 6 * tokens * n * (3 * d * w + 2 * w * w)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_gathered_train_flops_times_ranks_is_one_rank_times_replication(
        debug_mesh, small, arch):
    """A part the model axis does not divide (15 SSM heads, an RG-LRU
    width of 255 on 2 ranks) is computed whole on gathered leaves: every
    rank of the model axis repeats its compute, the rest splits."""
    cfg = gathered_part_config(arch)
    case, m = DR.measure_case(cfg, "train_4k", debug_mesh, microbatches=2)
    tp = case["tp"]
    assert tp is not None and not tp.ssm and not tp.lru
    assert m["model_axis_all_reduces"]["count"] > 0
    one = one_rank_flops(cfg, "train_4k", 2)
    c = S.SHAPES["train_4k"]
    tokens = c.global_batch * c.seq_len
    whole = whole_part_flops(cfg, tokens, one)
    replication = R.mesh_axis_size(debug_mesh, "model")
    want = one + (replication - 1) * (
        whole + repeated_flops(cfg, debug_mesh, tokens))
    assert abs(m["flops"] * debug_mesh.size() - want) <= FLOPS_REL * one


@pytest.mark.parametrize("microbatches,remat", [(1, False), (2, False),
                                                (1, True)])
def test_model_axis_all_reduces_per_layer(debug_mesh, small, microbatches,
                                          remat):
    """4 per layer + 1 for the embedding + 4 for the logits and the loss,
    per microbatch. Remat recomputes each layer's forward in the backward
    up to the last value the backward reads (torch's checkpoint stops
    early): the attention's all-reduce again, not the MLP's (its output
    is only added to the residual stream), one more per layer."""
    cfg = reduced("qwen3-1.7b", "train_4k")
    case, m = DR.measure_case(cfg, "train_4k", debug_mesh,
                              microbatches=microbatches, remat=remat)
    per_mb = (4 + remat) * cfg.n_layers + 1 + 4
    tp = m["model_axis_all_reduces"]
    assert tp["count"] == microbatches * per_mb
    assert tp["bytes"] > 0
    # they go through the counted collectives
    assert m["colls"]["all-reduce"]["count"] > tp["count"]


@pytest.mark.parametrize("microbatches,remat", [(1, False), (2, False),
                                                (1, True)])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "seamless-m4t-large-v2"])
def test_family_model_axis_all_reduces(debug_mesh, small, arch,
                                       microbatches, remat):
    """Per microbatch: granite-moe 5 per layer (attention 2; the MoE's
    output forward, its input's and gate weights' copies backward) + 5;
    seamless 4 per encoder layer + 6 per decoder layer (the cross-
    attention's output forward and its query's input backward besides
    the dense layer's 4) + 1 (the encoder output's copy, backward, once
    for every cross-attention) + 5. Remat recomputes a decoder layer up
    to the last value its backward reads: every attention output's
    all-reduce again (the residual stream's next norm reads it), not the
    FFN's or the MoE's (only added to the stream); the encoder is not
    recomputed. The MoE load balance's all-reduces over the batch axes
    are no model-axis ones."""
    cfg = reduced(arch, "train_4k")
    case, m = DR.measure_case(cfg, "train_4k", debug_mesh,
                              microbatches=microbatches, remat=remat)
    L = cfg.n_layers
    if cfg.is_encdec:
        per_mb = 4 * cfg.n_enc_layers + (6 + 2 * remat) * L + 1 + 5
    else:
        per_mb = (5 + remat) * L + 5
    tp = m["model_axis_all_reduces"]
    assert case["tp"] is not None
    assert tp["count"] == microbatches * per_mb
    assert m["colls"]["all-reduce"]["count"] > tp["count"]


@pytest.mark.parametrize("microbatches,remat", [(1, False), (2, False),
                                                (1, True)])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m"])
def test_recurrent_model_axis_all_reduces(debug_mesh, small, arch,
                                          microbatches, remat):
    """Per microbatch: recurrentgemma (r, r, a) 6 per RG-LRU layer + 4 for
    the attention layer + 5 = 21; mamba2 4 per layer + 5 = 13; plus two
    for each leaf stored split over "model" and taken whole (gathered,
    its gradient reduced: recurrentgemma's wk and wv, each Mamba2
    layer's in_proj and conv_w), 25 and 21. Remat
    recomputes each pattern block up to the last value its backward
    reads: recurrentgemma's block (r, r, a) the two RG-LRU layers' gather
    and output and their MLPs' outputs (read by the next layer's norm),
    and the attention's output, 7 more; a Mamba2 block (one layer) its
    norm's sum of squares, not its output (only added to the residual
    stream), one more a layer."""
    cfg = reduced(arch, "train_4k")
    case, m = DR.measure_case(cfg, "train_4k", debug_mesh,
                              microbatches=microbatches, remat=remat)
    types = cfg.layer_types()
    per_mb = 6 * types.count("rglru") + 4 * types.count("attn") \
        + 4 * types.count("ssm") + 5
    if remat:
        per_mb += 7 if cfg.rglru else cfg.n_layers
    gathers = TP.leaf_gather_all_reduces(cfg, S.params_shapes(cfg),
                                         debug_mesh, case["tp"])
    assert gathers == (4 if cfg.rglru else 4 * cfg.n_layers)
    per_mb += gathers
    tp = m["model_axis_all_reduces"]
    assert case["tp"] is not None
    assert tp["count"] == microbatches * per_mb
    assert m["colls"]["all-reduce"]["count"] > tp["count"]


@pytest.mark.parametrize("arch,shape,tensor_parallel,wq", [
    ("qwen3-1.7b", "train_4k", True, None),
    ("qwen3-1.7b", "decode_32k", True, None),
    ("granite-moe-1b-a400m", "train_4k", True, None),
    # ("rglru", "rglru", "attn"): the first attention block is the third;
    # its one kv head is gathered
    ("recurrentgemma-9b", "train_4k", True, "blocks/2/attn/wq"),
    # its serving step splits too, the kv head's wk and wv gathered
    ("recurrentgemma-9b", "decode_32k", True, "blocks/2/attn/wq"),
])
def test_record_says_tensor_parallel_and_gathered_leaves(
        debug_mesh, small, monkeypatch, arch, shape, tensor_parallel, wq):
    cfg = reduced(arch, shape)
    monkeypatch.setattr(DR.registry, "get", lambda a: cfg)
    rec = DR.run_case(arch, shape, debug_mesh, "pod1", verbose=False)
    assert rec["tensor_parallel"] is tensor_parallel
    # 4/2 heads, 2/2 kv heads; recurrentgemma's 1 kv head: wk, wv
    assert rec["gathered_leaves"] == ([] if wq is None else [
        wq.replace("wq", "wk"), wq.replace("wq", "wv")])
    assert rec["model_axis_all_reduces"]["count"] > 0


@pytest.mark.parametrize("dims,shape,want", [
    (("batch", None, "model"), (4, 6, 8), ("data", None, "model")),
    (("batch", None, "model"), (3, 6, 7), (None, None, None)),
    (("batch", "model", None), (2, 6, 8), ("data", "model", None)),
    (("batch", "model", None), (2, 5, 8), ("data", None, None)),
    (("batch", None, None, "model"), (4, 3, 2, 16),
     ("data", None, None, "model")),
    ((None, "model"), (4, 8), (None, "model")),
])
def test_constrain_gives_the_reference_spec(debug_mesh, dims, shape, want):
    from torch.distributed.tensor import Replicate, distribute_tensor
    x = distribute_tensor(torch.ones(shape), debug_mesh,
                          [Replicate(), Replicate()])
    assert R.constrain(x, dims) is x           # no ambient mesh
    with R.mesh_context(debug_mesh):
        y = R.constrain(x, dims)
    assert tuple(y.placements) == R.to_placements(debug_mesh, want)
    assert torch.equal(y.full_tensor(), x.full_tensor())
    plain = torch.ones(shape)
    with R.mesh_context(debug_mesh):
        assert R.constrain(plain, dims) is plain


def test_cli_exits_1_on_a_failed_case(monkeypatch, tmp_path, capsys):
    def boom(*a, **k):
        raise RuntimeError("injected")
    monkeypatch.setattr(DR, "run_case", boom)
    with pytest.raises(SystemExit) as e:
        DR.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                 "--debug-mesh", "--out", str(tmp_path)])
    assert e.value.code == 1
    assert "1 failures" in capsys.readouterr().out
    assert not dist.is_initialized()


def run_cli(args, tmp_path, timeout=120):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args, "--out", str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


RECORD_KEYS = {"flops_per_device", "bytes_accessed_per_device",
               "collectives", "collective_bytes_per_device", "memory",
               "meta", "param_count", "active_param_count",
               "corrected_per_device", "n_devices", "arch", "shape", "mesh",
               "tensor_parallel", "model_axis_all_reduces",
               "gathered_leaves"}


@pytest.mark.parametrize("arch,shape", [("qwen3-1.7b", "decode_32k"),
                                        ("mamba2-130m", "long_500k")])
def test_dryrun_cli_debug_mesh(tmp_path, arch, shape):
    r = run_cli(["--arch", arch, "--shape", shape, "--debug-mesh"], tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.load(open(tmp_path / f"{arch}__{shape}__pod1.json"))
    assert RECORD_KEYS <= set(out)
    assert out["n_devices"] == 4
    assert out["flops_per_device"] > 0
    assert out["corrected_per_device"]["flops"] == out["flops_per_device"]
    assert out["bytes_accessed_per_device"] is None
    assert out["memory"]["temp_size_in_bytes"] is not None
    assert set(out["collectives"]) >= set(DR.COLLECTIVES)


def test_dryrun_multipod_debug_mesh(tmp_path):
    r = run_cli(["--arch", "granite-moe-1b-a400m", "--shape", "train_4k",
                 "--debug-mesh", "--multi-pod-only"], tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.load(open(tmp_path /
                         "granite-moe-1b-a400m__train_4k__pod2.json"))
    assert out["n_devices"] == 8
    assert out["collective_bytes_per_device"] > 0   # grad all-reduce exists
    assert out["meta"]["microbatches"] == S.TRAIN_MICROBATCHES[
        "granite-moe-1b-a400m"]
