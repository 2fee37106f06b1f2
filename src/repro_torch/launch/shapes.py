"""Assigned input shapes and abstract input/sharding construction (the
reference's `repro.launch.shapes`).

For each (arch, shape) pair this module builds everything the dry-run
needs: the step callable, its abstract args (meta tensors: no allocation),
and the in/out spec trees, resolved against a mesh by the sharding rule
engine. The numbers are the reference's.

Shape semantics:
  train_4k    -> train_step (fwd+bwd+AdamW), grad accumulation per arch;
                 tensor parallel over "model" (every family)
  prefill_32k -> serve_prefill (full forward + cache emit)
  decode_32k  -> serve_decode: ONE token, KV state of 32,768 positions
  long_500k   -> serve_decode at position 524,287; sub-quadratic state
                 (SSM state / RG-LRU + local window / sliding-window
                 variant for the full-attention archs)
The serving shapes run tensor parallel over "model" for every family
(`spmd.call_split`: the decode caches' sequence split over "model", a
recurrent state whole on every rank).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.params import F32_LEAVES
from repro_torch.serve.step import build_decode, build_prefill
from repro_torch.sharding import rules as R
from repro_torch.sharding import tp as TP
from repro_torch.sharding.tp import TensorParallel, gathered_leaves
from repro_torch.train.step import build_lm_train_step

META = torch.device("meta")


@dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCase("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCase("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCase("long_500k", "decode", 524_288, 1),
}

# Baseline microbatch counts for train_4k (per-arch activation-memory lever)
TRAIN_MICROBATCHES = {
    "mistral-nemo-12b": 8, "pixtral-12b": 8, "recurrentgemma-9b": 8,
    "starcoder2-7b": 8, "qwen3-4b": 4, "qwen3-1.7b": 4,
    "granite-moe-3b-a800m": 4, "granite-moe-1b-a400m": 2,
    "seamless-m4t-large-v2": 2, "mamba2-130m": 1,
}


def dryrun_config(cfg):
    """bf16 everywhere + vocab padded to a 256 multiple (divisible by any
    model-axis size up to 256) + MoE experts padded to the model-axis
    multiple for expert-parallel sharding, for the production dry-run.
    Megatron-SP (seq_parallel) for dense-FFN attention stacks only: the
    reference measured it hurting MoE (sequence-global grouped dispatch)
    and SSM (sequence-global scan)."""
    kw = dict(dtype="bfloat16", param_dtype="bfloat16", vocab_pad_to=256)
    kw["seq_parallel"] = cfg.moe is None and cfg.family != "ssm"
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, pad_experts_to=16)
    return cfg.replace(**kw)


# ---------------------------------------------------------------- batches

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _train_batch_shapes(cfg, case: ShapeCase):
    B, S = case.global_batch, case.seq_len
    i32 = torch.int32
    adt = cfg.activation_dtype
    if cfg.is_encdec:
        # audio backbone: encoder frames + decoder tokens split the budget
        Se, Sd = S // 2, S // 2
        return {"tokens": _meta((B, Sd), i32),
                "labels": _meta((B, Sd), i32),
                "enc_embeds": _meta((B, Se, cfg.d_model), adt)}
    if cfg.embed_stub:
        # vlm: 1/4 image patches, 3/4 text
        Sp, St = S // 4, S - S // 4
        return {"tokens": _meta((B, St), i32),
                "labels": _meta((B, St), i32),
                "embeds": _meta((B, Sp, cfg.d_model), adt)}
    return {"tokens": _meta((B, S), i32),
            "labels": _meta((B, S), i32)}


def _prefill_batch_shapes(cfg, case: ShapeCase):
    b = _train_batch_shapes(cfg, case)
    b.pop("labels", None)
    return b


def decode_cache_len(cfg, case: ShapeCase) -> int:
    """Attention cache length for a decode shape: the native window for
    windowed archs, the long-context sliding window for full-attention archs
    at 500k, else the full sequence."""
    if cfg.window:
        return min(cfg.window, case.seq_len)
    if case.seq_len > 65_536:
        return cfg.long_context_window    # sliding-window variant
    return case.seq_len


def decode_window(cfg, case: ShapeCase) -> Optional[int]:
    if cfg.window:
        return cfg.window
    if case.seq_len > 65_536:
        return cfg.long_context_window
    return None


# ---------------------------------------------------------------- cases

def params_shapes(cfg):
    """The port's params as meta tensors, in their dtypes (the RG-LRU's and
    Mamba2's float32 leaves stay float32, as the init keeps them)."""
    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, path + (i,)) for i, v in enumerate(tree)]
        f32 = len(path) >= 2 and path[-1] in F32_LEAVES.get(path[-2], ())
        return _meta(tree, torch.float32 if f32 else cfg.parameter_dtype)
    return build(T.param_shapes(cfg))


def make_case(arch_cfg, shape_name: str, mesh, *, microbatches=None,
              remat=None):
    """Returns dict(fn, args, in_specs, out_specs, local_specs, donate,
    meta, tp, gathered_leaves); args are meta tensors (the optimizer's
    step counter a CPU scalar). A case on a mesh whose "model" axis is
    larger than 1 runs tensor parallel (`tp`, a
    `sharding.tp.TensorParallel` counting its all-reduces; else None):
    every case (a serving case run by `spmd.call_split`, its outputs on a
    rank laid out as `local_specs`); `gathered_leaves` names the leaves
    stored split over "model" whose compute is gathered."""
    case = SHAPES[shape_name]
    cfg = dryrun_config(arch_cfg)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    p_shapes = params_shapes(cfg)
    p_specs = R.param_specs(cfg, p_shapes, mesh)

    if case.kind == "train":
        mb = microbatches or TRAIN_MICROBATCHES.get(cfg.arch_id, 4)
        opt_init, opt_update = adamw(
            linear_warmup_cosine(3e-4, 100, 10_000))
        o_shapes = opt_init(p_shapes)
        o_specs = R.opt_state_specs(cfg, o_shapes, p_specs)
        b_shapes = _train_batch_shapes(cfg, case)
        b_specs = R.batch_specs(cfg, b_shapes, mesh)
        tp = TensorParallel.build(cfg, mesh)
        step = build_lm_train_step(cfg, opt_update, microbatches=mb, tp=tp)
        metric_specs = {k: R.P() for k in
                        ("xent", "loss", "load_balance", "router_z",
                         "dropped_frac", "grad_norm", "lr")}
        return dict(fn=step, args=(p_shapes, o_shapes, b_shapes),
                    in_specs=(p_specs, o_specs, b_specs),
                    out_specs=(p_specs, o_specs, metric_specs),
                    local_specs=None,
                    donate=(0, 1), meta={"microbatches": mb, "cfg": cfg},
                    tp=tp, gathered_leaves=gathered_leaves(cfg, p_shapes,
                                                           mesh, tp))

    tp = TensorParallel.build(cfg, mesh)
    if case.kind == "prefill":
        b_shapes = _prefill_batch_shapes(cfg, case)
        b_specs = R.batch_specs(cfg, b_shapes, mesh)
        # outputs: next_token (B,), caches (natural length), by running the
        # one-device forward on the meta tensors
        with torch.no_grad():
            cache_shapes = build_prefill(cfg)(p_shapes, b_shapes)[1]
        c_specs = R.prefill_cache_specs(cfg, cache_shapes, mesh)
        tok_spec = R.P(R.batch_axes(mesh))
        out_specs = (tok_spec, c_specs)
        return dict(fn=build_prefill(cfg, tp=tp), args=(p_shapes, b_shapes),
                    in_specs=(p_specs, b_specs), out_specs=out_specs,
                    local_specs=None if tp is None
                    else TP.prefill_local_specs(out_specs, tp),
                    donate=(), meta={"cfg": cfg}, tp=tp,
                    gathered_leaves=gathered_leaves(cfg, p_shapes, mesh,
                                                    tp))

    # decode
    B = case.global_batch
    clen = decode_cache_len(cfg, case)
    enc_len = (case.seq_len // 8) if cfg.is_encdec else 0
    cache_shapes = T.init_cache(cfg, B, clen, device=META, enc_len=enc_len)
    c_specs = R.cache_specs(cfg, cache_shapes, mesh)
    win = decode_window(cfg, case)
    split = TP.cache_split(c_specs)
    fn = build_decode(cfg, window=win, tp=tp, split=split)
    tok_shape = _meta((B, 1), torch.int32)
    pos_shape = _meta((B,), torch.int32)
    bspec = R.batch_specs(cfg, {"t": tok_shape}, mesh)["t"]
    pspec = R.P(bspec[0])
    return dict(fn=fn, args=(p_shapes, tok_shape, pos_shape, cache_shapes),
                in_specs=(p_specs, bspec, pspec, c_specs),
                out_specs=(pspec, c_specs), local_specs=None,
                donate=(3,),
                meta={"cache_len": clen, "window": win, "cfg": cfg,
                      "position": case.seq_len - 1},
                tp=tp, gathered_leaves=gathered_leaves(cfg, p_shapes, mesh,
                                                       tp))
