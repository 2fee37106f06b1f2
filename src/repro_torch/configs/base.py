"""Architecture configuration schema.

Every assigned architecture (and the paper's own tabular MLP) is described by a
``ModelConfig``. Configs are plain frozen dataclasses so they hash, compare and
serialize trivially — they are also the *task payload* of the sweep engine
(core/tasks.py), which is the paper's "parameters used to train the model"
MongoDB document, made typed.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _torch_dtype(name: str) -> torch.dtype:
    """The reference names dtypes by string and maps them to jnp dtypes;
    the port maps the same strings to torch dtypes."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                         f"got {name!r}") from None


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    pad_experts_to: int = 1     # pad expert arrays so E divides the model
                                # axis -> expert-parallel sharding (§Perf-5);
                                # padded experts are dead (router never
                                # selects them)
    # port only (the reference has neither field):
    shared_d_ff: int = 0        # a SiLU-gated shared expert of this width,
                                # added to the routed output (0: none)
    held_experts: int = 0       # this device's share of an expert-parallel
                                # deployment: experts first_held ..
                                # first_held + held - 1 (0: all). The
    first_held: int = 0         # router keeps all n_experts; what the
                                # others would add is left out

    @property
    def padded_n_experts(self) -> int:
        m = self.pad_experts_to
        return ((self.n_experts + m - 1) // m) * m

    @property
    def n_held(self) -> int:
        """Experts whose weights are held here (the expert weights' lead
        dim)."""
        return self.held_experts or self.padded_n_experts

    @property
    def held(self) -> range:
        return range(self.first_held, self.first_held + self.n_held)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin recurrent block config [arXiv:2402.19427]."""
    lru_width: int = 0            # 0 => d_model
    d_conv: int = 4
    c_exponent: float = 8.0       # the fixed `c` in a = exp(-c * softplus(L) * r)


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio | mlp
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // n_heads
    # attention variants
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding-window size (None => full)
    long_context_window: int = 4096       # window used by the long_500k variant
    # per-layer mixer pattern for hybrids, e.g. ("rglru","rglru","attn")
    block_pattern: Tuple[str, ...] = ("attn",)
    tail_pattern: Tuple[str, ...] = ()    # layers that don't fit the block scan
    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # enc-dec
    n_enc_layers: int = 0                 # >0 => encoder-decoder
    # modality frontend stub: model consumes (B, S_prefix, d_model) embeddings
    embed_stub: bool = False
    # misc
    mlp_gated: bool = True                # SwiGLU-style 3-matrix MLP; False =
                                          # classic 2-matrix (starcoder2)
    tie_embeddings: bool = True
    scan_layers: bool = True              # lax.scan over blocks (False: unroll)
    seq_parallel: bool = False            # Megatron-SP: residual stream seq-
                                          # sharded over "model" between TP
                                          # regions (§Perf iteration 6)
    vocab_pad_to: int = 1                 # pad embed/unembed vocab to a
                                          # multiple (Megatron-style; §Perf-4:
                                          # indivisible vocab -> replicated
                                          # f32 logits on every device)
    norm_eps: float = 1e-6
    act: str = "silu"                     # mlp activation
    dtype: str = "float32"                # activation dtype
    param_dtype: str = "float32"
    remat: bool = False                   # activation checkpointing per layer block
    attention_impl: str = "xla"           # xla | pallas. In the port "pallas"
                                          # means the ports of the Pallas
                                          # kernels (flash attention, RG-LRU
                                          # scan, SSD scan): the CUDA kernel
                                          # on CUDA tensors, its plain
                                          # version on CPU tensors; "xla" the
                                          # plain torch composition the
                                          # reference runs there (dense SDPA,
                                          # log-depth scan, chunked SSD)
    source: str = ""                      # citation bracket from the assignment
    # ----- port only (the reference has none of these; each default
    # leaves a model as the reference runs it) -----
    ssm_ffn: bool = False                 # Mamba2 layers end in norm2 + FFN
    nope: bool = False                    # no positional encoding (no RoPE)
    embedding_multiplier: float = 1.0     # Granite's four multipliers:
    attention_multiplier: float = 0.0     # the embedding, the attention
    residual_multiplier: float = 1.0      # scale (0: 1/sqrt(head_dim)),
    logits_scaling: float = 1.0           # each residual branch, and the
                                          # logits' divisor

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attention_scale(self) -> float:
        return self.attention_multiplier or \
            1.0 / math.sqrt(self.resolved_head_dim)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def activation_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    @property
    def parameter_dtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    def layer_types(self) -> Tuple[str, ...]:
        """Full, ordered per-layer mixer list (decoder stack)."""
        n_block = len(self.block_pattern)
        n_tail = len(self.tail_pattern)
        n_scan = self.n_layers - n_tail
        assert n_scan % n_block == 0, (
            f"{self.arch_id}: {self.n_layers} layers minus {n_tail} tail not "
            f"divisible by block pattern {self.block_pattern}")
        return self.block_pattern * (n_scan // n_block) + self.tail_pattern

    @property
    def n_blocks(self) -> int:
        return (self.n_layers - len(self.tail_pattern)) // len(self.block_pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        mlp = (3 if self.mlp_gated else 2) * d * ff
        if self.moe:
            m = self.moe
            held = m.held_experts or m.n_experts
            mlp = held * 3 * d * m.expert_d_ff + d * m.n_experts \
                + 3 * d * m.shared_d_ff
        total = 0
        for t in self.layer_types():
            if t == "ssm" and self.ssm_ffn:
                total += mlp + d
            if t == "attn":
                total += attn + mlp + 2 * d
            elif t == "rglru":
                w = (self.rglru.lru_width or d)
                total += 2 * d * w + w * d + 3 * w + self.rglru.d_conv * w + mlp + 2 * d
            elif t == "ssm":
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                conv_dim = di + 2 * s.n_groups * s.d_state
                total += d * (2 * di + 2 * s.n_groups * s.d_state + nh) \
                    + s.d_conv * conv_dim + di * d + 2 * nh + di
            else:
                raise ValueError(t)
        if self.is_encdec:
            # encoder self-attn + mlp, decoder cross-attn
            total += self.n_enc_layers * (attn + mlp + 2 * d)
            total += self.n_layers * (attn + d)  # cross attention + its norm
        total += v * d  # embedding (tied head)
        if not self.tie_embeddings:
            total += v * d
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE counts top_k experts only)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        per_expert = 3 * self.d_model * self.moe.expert_d_ff
        inactive = (self.moe.n_experts - self.moe.top_k) * per_expert * self.n_layers
        return full - inactive



@dataclass(frozen=True)
class MLPConfig:
    """The paper's own subject: a tabular MLP classifier (models/dnn.py)."""
    n_features: int
    n_classes: int
    hidden_sizes: Tuple[int, ...] = (64, 64)
    activations: Tuple[str, ...] = ("relu",)   # cycled across layers (paper F3)
    dropout: float = 0.0
    param_dtype: str = "float32"

    @property
    def parameter_dtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    def replace(self, **kw) -> "MLPConfig":
        return dataclasses.replace(self, **kw)
