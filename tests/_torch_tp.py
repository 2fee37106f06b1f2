"""Rank functions for the tensor-parallel tests
(tests/test_torch_tensor_parallel.py,
tests/test_torch_tensor_parallel_families.py,
tests/test_torch_tensor_parallel_recurrent.py and the three
tests/test_torch_tensor_parallel_serving*.py), run on gloo ranks by
`_torch_dist.spawn`, and the inputs they share with the one-device
references (numpy draws from a seed)."""
import contextlib
import dataclasses

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

B, S = 2, 16


def attn_config(case: str):
    """The reduced qwen3-1.7b (4 heads, 2 kv heads, head_dim 64, qk-norm),
    or, for "straddle", 12 heads over 3 kv heads (groups of 4 straddle the
    ranks of 2 and 4)."""
    from repro_torch.configs import registry
    cfg = registry.get("qwen3-1.7b", reduced=True)
    if case == "straddle":
        cfg = cfg.replace(n_heads=12, n_kv_heads=3, head_dim=16)
    return cfg


def padded_config():
    """Reduced qwen3-1.7b with a vocabulary of 500 padded to 512."""
    from repro_torch.configs import registry
    return registry.get("qwen3-1.7b", reduced=True).replace(
        vocab_size=500, vocab_pad_to=128)


def operator_inputs(case: str, seed: int = 0) -> dict:
    """Full weights and inputs of one operator case, as numpy arrays."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    if case in ("mlp_gated", "mlp"):
        d, ff = 256, 512
        out = {"w_up": n(d, ff, scale=d ** -0.5),
               "w_down": n(ff, d, scale=ff ** -0.5),
               "x": n(B, S, d), "g": n(B, S, d)}
        if case == "mlp_gated":
            out["w_gate"] = n(d, ff, scale=d ** -0.5)
        return out
    if case in ("attention", "straddle"):
        cfg = attn_config(case)
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nh, nkv = cfg.n_heads, cfg.n_kv_heads
        return {"wq": n(d, nh * hd, scale=d ** -0.5),
                "wk": n(d, nkv * hd, scale=d ** -0.5),
                "wv": n(d, nkv * hd, scale=d ** -0.5),
                "wo": n(nh * hd, d, scale=(nh * hd) ** -0.5),
                "q_norm": n(hd, scale=0.1), "k_norm": n(hd, scale=0.1),
                "x": n(B, S, d), "g": n(B, S, d)}
    cfg = padded_config()
    V, d = cfg.padded_vocab_size, cfg.d_model
    if case == "embed":
        return {"table": n(V, d, scale=0.02),
                "tokens": rng.integers(0, cfg.vocab_size, (B, S)),
                "g": n(B, S, d)}
    if case == "logits":
        return {"table": n(V, d, scale=0.02), "x": n(B, S, d),
                "g": n(B, S, V)}
    # xent: logits as `_logits` gives them (padding at -1e30)
    logits = n(B, S, V, scale=3.0)
    logits[..., cfg.vocab_size:] = -1e30
    return {"logits": logits,
            "labels": rng.integers(0, cfg.vocab_size, (B, S)),
            "mask": (rng.random((B, S)) < 0.7).astype(np.float32)}


OPERATOR_CASES = ("mlp_gated", "mlp", "attention", "straddle", "embed",
                  "logits", "xent", "xent_masked")


def _cols(w, r, k):
    n = w.shape[1] // k
    return w[:, r * n:(r + 1) * n]


def _rows(w, r, k):
    n = w.shape[0] // k
    return w[r * n:(r + 1) * n]


def run_operator(case: str, inp: dict, tp=None) -> dict:
    """One operator's forward and the gradients of (out * g).sum() (for the
    loss: of the loss), with `tp` on this rank's shards of `inp`, or on one
    device with tp=None. Returns the output and every input's gradient:
    the shards' and, for gathered leaves used inside the head split, the
    rank's partial sums."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.sharding import tp as TP
    from repro_torch.train.losses import softmax_xent
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in inp.items()}
    r, k = (0, 1) if tp is None else (tp.rank, tp.size)
    if case in ("mlp_gated", "mlp"):
        p = {"w_up": _cols(t["w_up"], r, k), "w_down": _rows(t["w_down"], r, k)}
        if "w_gate" in t:
            p["w_gate"] = _cols(t["w_gate"], r, k)
        act = "silu" if case == "mlp_gated" else "gelu"
        leaves = {**p, "x": t["x"]}
        _track(leaves)
        out = L.mlp({n: leaves[n] for n in p}, leaves["x"], act, tp)
    elif case in ("attention", "straddle"):
        cfg = attn_config(case)
        kv_split = tp is None or tp.kv
        p = {"wq": _cols(t["wq"], r, k),
             "wk": _cols(t["wk"], r, k) if kv_split else t["wk"],
             "wv": _cols(t["wv"], r, k) if kv_split else t["wv"],
             "wo": _rows(t["wo"], r, k),
             "q_norm": {"scale": t["q_norm"]},
             "k_norm": {"scale": t["k_norm"]}}
        leaves = {"wq": p["wq"], "wk": p["wk"], "wv": p["wv"],
                  "wo": p["wo"], "q_norm": p["q_norm"]["scale"],
                  "k_norm": p["k_norm"]["scale"], "x": t["x"]}
        _track(leaves)
        p = {"wq": leaves["wq"], "wk": leaves["wk"], "wv": leaves["wv"],
             "wo": leaves["wo"], "q_norm": {"scale": leaves["q_norm"]},
             "k_norm": {"scale": leaves["k_norm"]}}
        pos = torch.arange(S)[None, :]
        out = L.attention(p, cfg, leaves["x"], pos, causal=True, tp=tp)[0]
    elif case == "embed":
        leaves = {"table": _rows(t["table"], r, k)}
        _track(leaves)
        out = L.embed(leaves, t["tokens"], tp)
    elif case == "logits":
        cfg = padded_config()
        leaves = {"table": _rows(t["table"], r, k), "x": t["x"]}
        _track(leaves)
        out = T._logits({"embed": {"table": leaves["table"]}}, cfg,
                        leaves["x"], tp)
        t["g"] = _cols(t["g"].reshape(-1, t["g"].shape[-1]), r, k).reshape(
            out.shape)
    else:
        mask = t["mask"] if case == "xent_masked" else None
        smooth = 0.1 if case == "xent_masked" else 0.0
        logits = t["logits"]
        leaves = {"logits": _cols(logits.reshape(-1, logits.shape[-1]),
                                  r, k).reshape(B, S, -1)}
        _track(leaves)
        if tp is None:
            out = softmax_xent(leaves["logits"], t["labels"], mask, smooth)
        else:
            out = TP.vocab_parallel_xent(leaves["logits"], t["labels"],
                                         mask, smooth, tp=tp)
    loss = out if out.ndim == 0 else (out * t["g"]).sum()
    loss.backward()
    return {"out": out.detach(),
            **{f"d_{n}": v.grad for n, v in leaves.items()}}


def _track(leaves: dict):
    for n in leaves:
        leaves[n] = leaves[n].clone().requires_grad_()


def operator_ranks(rank, world, cases):
    """Every case of `cases` on this rank's shards, on a ("model",) mesh
    of all the ranks (f32, TF32 off)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.sharding.tp import TensorParallel
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    out = {}
    for case in cases:
        cfg = attn_config(case) if case in ("attention", "straddle") \
            else padded_config()
        tp = TensorParallel.build(cfg, mesh)
        out[case] = run_operator(case, operator_inputs(case), tp)
        out[case]["kv_split"] = tp.kv
    return out


# ------------------------------------------------------------ MoE operator

MOE_CASES = ("expert", "d_ff", "drops")


def family_config(case: str, registry=None):
    """A training or operator case's config, from the port's registry or
    the reference's (`registry`): reduced granite-moe-1b-a400m (4 experts
    top-2, expert d_ff 128) for "expert" and "granite-moe-1b-a400m";
    with 3 experts (no model axis of 2 or 4 divides them: each expert's
    d_ff splits) for "d_ff" and "granite-moe-e3"; at capacity factor 0.5
    (entries dropped) for "drops"; with the load-balance coefficient
    raised from 0.01 to 1 (its gradient above the tests' bars) for
    "granite-moe-lb"; any other name a reduced arch."""
    if registry is None:
        from repro_torch.configs import registry
    moe = {"expert": {}, "d_ff": {"n_experts": 3},
           "granite-moe-e3": {"n_experts": 3},
           "drops": {"capacity_factor": 0.5},
           "granite-moe-lb": {"load_balance_coef": 1.0}}.get(case)
    if moe is None:
        return registry.get(case, reduced=True)
    cfg = registry.get("granite-moe-1b-a400m", reduced=True)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))


def moe_inputs(case: str, seed: int = 1) -> dict:
    """Full MoE weights and inputs of one operator case, as numpy arrays
    (the router at unit scale: well separated top-k logits)."""
    cfg = family_config(case)
    rng = np.random.default_rng(seed)
    d, ff = cfg.d_model, cfg.moe.expert_d_ff
    E, Ep = cfg.moe.n_experts, cfg.moe.padded_n_experts

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"router": n(d, E, scale=d ** -0.5),
            "w_gate": n(Ep, d, ff, scale=d ** -0.5),
            "w_up": n(Ep, d, ff, scale=d ** -0.5),
            "w_down": n(Ep, ff, d, scale=ff ** -0.5),
            "x": n(B, S, d), "g": n(B, S, d)}


def moe_shard(name: str, w, how, r: int, k: int):
    """The rank's compute shard of expert leaf `name` under the split
    `how` ("expert", "d_ff" or None)."""
    if how is None or name == "router":
        return w
    if how == "expert":
        return _rows(w, r, k)
    if name == "w_down":
        n = w.shape[1] // k
        return w[:, r * n:(r + 1) * n]
    n = w.shape[2] // k
    return w[..., r * n:(r + 1) * n]


def run_moe(case: str, inp: dict, tp=None) -> dict:
    """The MoE FFN's forward and the gradients of (out * g).sum() plus
    its load-balance and z losses, with `tp` on this rank's expert
    shards, or on one device with tp=None."""
    from repro_torch.models import moe as MOE
    cfg = family_config(case)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in inp.items()}
    r, k, how = (0, 1, None) if tp is None else (tp.rank, tp.size,
                                                 tp.experts)
    leaves = {name: moe_shard(name, t[name], how, r, k)
              for name in ("router", "w_gate", "w_up", "w_down")}
    leaves["x"] = t["x"]
    _track(leaves)
    out, aux = MOE.moe_ffn({n: leaves[n] for n in ("router", "w_gate",
                                                   "w_up", "w_down")},
                           cfg, leaves["x"], want_aux=True, tp=tp)
    loss = (out * t["g"]).sum() + aux["load_balance"] + aux["router_z"]
    loss.backward()
    return {"out": out.detach(), "split": how,
            **{k: float(v.detach()) for k, v in aux.items()},
            **{f"d_{n}": v.grad for n, v in leaves.items()}}


def moe_ranks(rank, world, cases):
    """Every MoE case on this rank's expert shards, on a ("model",) mesh
    of all the ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.sharding.tp import TensorParallel
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    return {case: run_moe(case, moe_inputs(case),
                          TensorParallel.build(family_config(case), mesh))
            for case in cases}


# ------------------------------------------------------------ recurrent

RECURRENT_CASES = ("gather", "gather_rows", "norm", "rglru", "mamba2",
                   "mamba2_g2")


def recurrent_config(case: str):
    """Reduced recurrentgemma-9b (lru width 256) for "rglru", reduced
    mamba2-130m (16 heads of 32, d_state 32, one group) for "mamba2" and
    the norm, and its 2-group variant for "mamba2_g2" (8 heads a group: on
    2 ranks each rank's heads read one whole group, on 4 two ranks share
    one)."""
    from repro_torch.configs import registry
    if case == "rglru":
        return registry.get("recurrentgemma-9b", reduced=True)
    cfg = registry.get("mamba2-130m", reduced=True)
    if case == "mamba2_g2":
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, n_groups=2))
    return cfg


def recurrent_inputs(case: str, seed: int = 2, cfg=None) -> dict:
    """Full weights and inputs of one recurrent case, as numpy arrays
    (gates and decays near the init's ranges, the norm's input well away
    from zero); a block case's sizes from `cfg` where given."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(
            np.float32)
    if case == "gather":
        return {"x": n(B, S, 64), "g": n(B, S, 64)}
    if case == "gather_rows":       # a leaf stored split by rows
        return {"x": n(16, 32), "g": n(16, 32)}
    cfg = recurrent_config(case) if cfg is None else cfg
    d = cfg.d_model
    if case == "norm":
        di = cfg.ssm.d_inner(d)
        return {"y": n(B, S, di), "w": n(di, scale=0.1), "g": n(B, S, di)}
    if case == "rglru":
        w, k = cfg.rglru.lru_width, cfg.rglru.d_conv
        u = rng.uniform(0.9, 0.999, w)
        lam = np.log(np.expm1(-np.log(u) / cfg.rglru.c_exponent))
        return {"w_x": n(d, w, scale=d ** -0.5),
                "w_gate_branch": n(d, w, scale=d ** -0.5),
                "conv_w": n(k, w, scale=1.0 / k), "conv_b": n(w, scale=0.1),
                "w_r": n(w, w, scale=w ** -0.5), "b_r": n(w, scale=0.1),
                "w_i": n(w, w, scale=w ** -0.5), "b_i": n(w, scale=0.1),
                "Lambda": lam.astype(np.float32),
                "out_proj": n(w, d, scale=w ** -0.5),
                "x": n(B, S, d), "g": n(B, S, d)}
    s = cfg.ssm
    di, nh = s.d_inner(d), s.n_heads(d)
    cd = di + 2 * s.n_groups * s.d_state
    return {"in_proj": n(d, di + cd + nh, scale=d ** -0.5),
            "conv_w": n(s.d_conv, cd, scale=1.0 / s.d_conv),
            "conv_b": n(cd, scale=0.1),
            "A_log": np.log(rng.uniform(1, 16, nh)).astype(np.float32),
            "dt_bias": n(nh, scale=0.5, shift=-3.0), "D": n(nh, shift=1.0),
            "norm_scale": n(di, scale=0.1),
            "out_proj": n(di, d, scale=di ** -0.5),
            "x": n(B, S, d), "g": n(B, S, d)}


# how each leaf of a recurrent case lies on a rank: "cols"/"rows" its
# shard (its gradient the shard's), "full" whole (its gradient the whole
# one's), "partial" whole, its gradient a share of the sum over the ranks
RECURRENT_LAYOUT = {
    "gather": {"x": "cols"},
    "gather_rows": {"x": "rows"},
    "norm": {"y": "cols", "w": "cols"},
    "rglru": {"w_x": "cols", "w_gate_branch": "cols", "conv_w": "cols",
              "conv_b": "partial", "w_r": "cols", "b_r": "partial",
              "w_i": "cols", "b_i": "partial", "Lambda": "partial",
              "out_proj": "rows", "x": "full"},
    "mamba2": {"in_proj": "partial", "conv_w": "partial",
               "conv_b": "partial", "A_log": "partial", "dt_bias": "partial",
               "D": "partial", "norm_scale": "partial", "out_proj": "rows",
               "x": "full"},
}
RECURRENT_LAYOUT["mamba2_g2"] = RECURRENT_LAYOUT["mamba2"]
RECURRENT_OUT = {"norm": "cols"}     # the others: whole on every rank


def lay(t, how, r, k):
    """`t` as rank r of k holds it under `how` (RECURRENT_LAYOUT)."""
    if how == "cols":
        n = t.shape[-1] // k
        return t[..., r * n:(r + 1) * n]
    if how == "rows":
        n = t.shape[0] // k
        return t[r * n:(r + 1) * n]
    return t


def run_recurrent(case: str, inp: dict, tp=None) -> dict:
    """One recurrent case's forward and the gradients of (out * g).sum()
    with `tp` on this rank's leaves (RECURRENT_LAYOUT), or on one device
    with tp=None; "gather" takes (gather_from_model(x) * g_r).sum(), a g
    of each rank's own (g rolled by the rank: the one-device gradient of
    their sum over the ranks is the sum of the rolls), on one device
    (x * g).sum(); "gather_rows" gathers x's rows as `spmd.split_params`
    gathers a leaf stored split that every rank uses whole (partial=
    False: the same g on every rank, so no reduction). Returns the output
    and every leaf's gradient."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import rglru as RG
    from repro_torch.sharding import tp as TP
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in inp.items()}
    r, k = (0, 1) if tp is None else (tp.rank, tp.size)
    leaves = {name: lay(t[name], how, r, k)
              for name, how in RECURRENT_LAYOUT[case].items()}
    _track(leaves)
    if case == "gather":
        out = leaves["x"] * 1.0 if tp is None \
            else TP.gather_from_model(leaves["x"], tp)
        g = torch.roll(t["g"], r, dims=-1)
    elif case == "gather_rows":
        out = leaves["x"] * 1.0 if tp is None else TP.gather_from_model(
            leaves["x"], tp, dim=0, partial=False)
        g = t["g"]
    elif case == "norm":
        out = L.rms_norm(leaves["y"], leaves["w"], 1e-6, tp)
        g = lay(t["g"], "cols", r, k)
    else:
        cfg = recurrent_config(case)
        p = {n: v for n, v in leaves.items() if n != "x"}
        block = RG.rglru_block_forward if case == "rglru" \
            else M2.mamba2_forward
        out, _ = block(p, cfg, leaves["x"], tp=tp)
        g = t["g"]
    (out * g).sum().backward()
    return {"out": out.detach(),
            **{f"d_{n}": v.grad for n, v in leaves.items()}}


def recurrent_ranks(rank, world, cases):
    """Every recurrent case on this rank's leaves, on a ("model",) mesh
    of all the ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.sharding.tp import TensorParallel
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    out = {}
    for case in cases:
        tp = TensorParallel.build(recurrent_config(case), mesh)
        out[case] = run_recurrent(case, recurrent_inputs(case), tp)
        out[case]["split"] = (tp.lru, tp.ssm)
    return out


# ------------------------------------------------------------ recurrent serving

LAYER_CASES = ("rglru", "rglru_255", "mamba2", "mamba2_g2", "mamba2_15")
LAYER_ROWS, LAYER_SEQ = 4, 16
DECODE_ROWS = (0, 2)     # the rows a `rows=` decode step writes


def layer_config(case: str):
    """`recurrent_config`'s, and the variants whose part the model axis (2
    or 4) does not divide: an RG-LRU width of 255 ("rglru_255"), 15 SSM
    heads (d_model 240, "mamba2_15")."""
    if case == "rglru_255":
        cfg = recurrent_config("rglru")
        return cfg.replace(rglru=dataclasses.replace(cfg.rglru,
                                                     lru_width=255))
    if case == "mamba2_15":
        return recurrent_config("mamba2").replace(d_model=240)
    return recurrent_config(case)


def layer_inputs(case: str, seed: int = 5) -> dict:
    """One recurrent decoder layer of `layer_config(case)` as numpy arrays:
    the mixer's weights (`recurrent_inputs`), the norms' scales, the
    RG-LRU layer's gated MLP, a prefill input (LAYER_ROWS, LAYER_SEQ, d),
    a decode token (LAYER_ROWS, 1, d) at positions 20.., and a whole
    decode state (h near a few steps' size, the conv window as the
    branch's)."""
    cfg = layer_config(case)
    base = "rglru" if cfg.rglru else "mamba2"
    mixer = recurrent_inputs(base, seed, cfg)
    rng = np.random.default_rng(seed + 1)
    d = cfg.d_model

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    out = {"mixer": {k: v for k, v in mixer.items() if k not in ("x", "g")},
           "norm1": n(d, scale=0.1), "x": n(LAYER_ROWS, LAYER_SEQ, d),
           "x1": n(LAYER_ROWS, 1, d),
           "pos": np.arange(20, 20 + LAYER_ROWS, dtype=np.int32)}
    k = (cfg.rglru or cfg.ssm).d_conv - 1
    if cfg.rglru:
        w, f = cfg.rglru.lru_width, cfg.d_ff
        out.update(norm2=n(d, scale=0.1),
                   ffn={"w_gate": n(d, f, scale=d ** -0.5),
                        "w_up": n(d, f, scale=d ** -0.5),
                        "w_down": n(f, d, scale=f ** -0.5)},
                   state={"h": n(LAYER_ROWS, w),
                          "conv": n(LAYER_ROWS, k, w, scale=0.5)})
    else:
        s = cfg.ssm
        nh = s.n_heads(d)
        cd = s.d_inner(d) + 2 * s.n_groups * s.d_state
        out["state"] = {"ssm": n(LAYER_ROWS, nh, s.head_dim, s.d_state,
                                 scale=0.3),
                        "conv": n(LAYER_ROWS, k, cd, scale=0.5)}
    return out


def run_layer(case: str, inp: dict, tp=None) -> dict:
    """One recurrent decoder layer of `case` (`transformer._layer_full` with
    want_cache, the prefill's path, then `transformer._layer_decode` from
    the whole state, once writing every row and once only DECODE_ROWS),
    on one device (tp=None) or with `tp` on this rank's leaves
    (RECURRENT_LAYOUT where the part splits, else whole; the MLP's columns
    and rows). Returns the outputs, the states (whole: the rank's after
    the gathers), whether the part split, and the all-reduces of each
    call."""
    from repro_torch.models import transformer as T
    cfg = layer_config(case)
    base = "rglru" if cfg.rglru else "mamba2"
    t = {k: (tree_map(torch.from_numpy, v) if isinstance(v, dict)
             else torch.from_numpy(v)) for k, v in inp.items()}
    r, k = (0, 1) if tp is None else (tp.rank, tp.size)
    split = tp is not None and (tp.lru if cfg.rglru else tp.ssm)
    layout = RECURRENT_LAYOUT[base] if split else {}
    mixer = {name: lay(v, layout.get(name, "full"), r, k)
             for name, v in t["mixer"].items()}
    lp = {"norm1": {"scale": t["norm1"]}}
    if cfg.rglru:
        ffn = tp is not None and tp.ffn
        lp.update(rglru=mixer, norm2={"scale": t["norm2"]}, ffn={
            name: lay(v, ("rows" if name == "w_down" else "cols")
                      if ffn else "full", r, k)
            for name, v in t["ffn"].items()})
        ltype = "rglru"
    else:
        lp["mamba"] = mixer
        ltype = "ssm"
    counts = {}

    def counted(name, fn):
        before = 0 if tp is None else tp.all_reduces
        out = fn()
        counts[name] = 0 if tp is None else tp.all_reduces - before
        return out
    positions = torch.arange(LAYER_SEQ)[None, :]
    with torch.no_grad():
        y, state, _ = counted("prefill", lambda: T._layer_full(
            lp, cfg, ltype, t["x"], positions, None, want_cache=True,
            tp=tp))
        res = {"prefill_out": y, "prefill_state": state, "split": split}
        for name, rows in (("all", range(LAYER_ROWS)),
                           ("rows", DECODE_ROWS)):
            cache = {n: v.clone() for n, v in t["state"].items()}
            res[f"decode_{name}"] = counted(name, lambda: T._layer_decode(
                lp, cfg, ltype, t["x1"], t["pos"], cache, None,
                torch.tensor(rows), tp))
            res[f"state_{name}"] = cache
    res["all_reduces"] = counts
    return res


def layer_ranks(rank, world, cases):
    """Every recurrent layer case on this rank's leaves, on a ("model",)
    mesh of all the ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.sharding.tp import TensorParallel
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    return {case: run_layer(case, layer_inputs(case), TensorParallel.build(
        layer_config(case), mesh)) for case in cases}


# ------------------------------------------------------------ training

STREAM = dict(seq=32, batch=8, seed=0, branch=4)
ENC_FRAMES = 16          # an encoder-decoder's stub frames per row


class stream:
    """The token stream of the training tests; for an encoder-decoder
    each batch also carries "enc_embeds" (B, ENC_FRAMES, d), normal
    draws at 0.5 from numpy's generator seeded by the batch's index (the
    reference's tests/test_torch_tensor_parallel_families.py script draws
    the same)."""

    def __init__(self, cfg):
        from repro_torch.data.tokens import TokenStream
        self.cfg, self.i = cfg, 0
        self.tokens = TokenStream(cfg.vocab_size, STREAM["seq"],
                                  STREAM["batch"], seed=STREAM["seed"],
                                  branch=STREAM["branch"])

    def next_batch(self) -> dict:
        batch = self.tokens.next_batch()
        if self.cfg.is_encdec:
            rng = np.random.default_rng(1000 + self.i)
            batch["enc_embeds"] = (rng.standard_normal(
                (STREAM["batch"], ENC_FRAMES, self.cfg.d_model)) * 0.5
            ).astype(np.float32)
        self.i += 1
        return batch

    def __iter__(self):
        while True:
            yield self.next_batch()


def init_params(cfg, ref_path):
    """The reference's initial params (pickled by its run), bridged."""
    import pickle
    from repro_torch.params import params_from_jax
    with open(ref_path, "rb") as f:
        tree = pickle.load(f)["init"]
    return params_from_jax(tree, cfg, device="cpu")


def step_grads(cfg, mesh, params, *, microbatches=1, shapes=None):
    """The gradients (full tensors) and metrics of the mesh step on the
    stream's first batch. With `shapes` (a list), the shape of every op's
    output during it is appended there."""
    from repro_torch.launch import distributed as D
    from repro_torch.optim import adamw
    opt_init, _ = adamw(1e-3)
    dp, opt, _, _ = D.shard_model(cfg, mesh, params, opt_init(params))
    got = []

    def record(grads, state, p):
        got.extend(tree_leaves(grads))
        return p, state, {}
    batch = stream(cfg).next_batch()
    step, b_specs = D.make_sharded_step(cfg, mesh, record, None, None, batch,
                                        microbatches=microbatches)
    dbatch = D.put_batch(mesh, b_specs, batch)
    if shapes is None:
        _, _, m = step(dp, opt, dbatch)
    else:
        with ShapeRecorder(shapes):
            _, _, m = step(dp, opt, dbatch)
    return ([x.full_tensor() for x in got],
            {k: float(v) for k, v in m.items()})


class ShapeRecorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Appends the shape of every plain tensor an op returns."""

    def __init__(self, shapes: list):
        super().__init__()
        self.shapes = shapes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if type(t) is torch.Tensor:
                self.shapes.append(tuple(t.shape))
        return out


@contextlib.contextmanager
def count_batch_reduces():
    """A list that gains one entry per all-reduce over the batch dims
    (`spmd.global_batch_mean`'s, forward or backward) while open."""
    from repro_torch.sharding import spmd
    plain, calls = spmd._all_reduce_over, []

    def counted(x, groups):
        calls.append(len(groups))
        return plain(x, groups)
    spmd._all_reduce_over = counted
    try:
        yield calls
    finally:
        spmd._all_reduce_over = plain


def tp_train_ranks(rank, world, arch, ref_path, mesh_shape, names, steps,
                   lr, log_every, variants):
    """On a mesh of `mesh_shape` / `names`: step 1's gradients for each
    (microbatches, remat) of `variants`, and `train_sharded`'s logged
    losses over `steps` steps (None: no run); with ("shapes", ...) in
    variants, the op output shapes of a plain step. Gradients and params
    from rank 0 only."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import registry
    from repro_torch.launch import distributed as D
    from repro_torch.sharding.tp import TensorParallel
    cfg = family_config(arch, registry)
    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
    params = init_params(cfg, ref_path)
    out = {"tp": TensorParallel.build(cfg, mesh) is not None}
    for mb, remat in variants:
        if mb == "shapes":
            shapes = []
            step_grads(cfg, mesh, tree_map(torch.clone, params),
                       shapes=shapes)
            out["shapes"] = sorted(set(shapes))
            continue
        c = cfg.replace(remat=remat)
        with count_batch_reduces() as calls:
            g, m = step_grads(c, mesh, tree_map(torch.clone, params),
                              microbatches=mb)
        out[(mb, remat)] = {"grads": g if rank == 0 else None,
                            "loss": m["loss"], "metrics": m,
                            "batch_reduces": len(calls)}
    if steps:
        D.T.init_lm = lambda gen, c: init_params(c, ref_path)
        _, _, losses = D.train_sharded(
            cfg, mesh, iter(stream(cfg)), num_steps=steps, lr=lr,
            log_every=log_every, verbose=False)
        out["losses"] = losses
    return out


def one_rank_grads(cfg, params, microbatches=1):
    """Step 1's gradients and loss of the unsharded step, one device."""
    from repro_torch.train.step import build_lm_train_step
    got = []

    def record(g, s, p):
        got.extend(tree_leaves(g))
        return p, s, {}
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in stream(cfg).next_batch().items()}
    _, _, m = build_lm_train_step(cfg, record, microbatches=microbatches)(
        params, None, batch)
    return got, float(m["loss"])


# ------------------------------------------------------------ serving

SERVE_ROWS, SERVE_PROMPT, SERVE_STEPS = 4, 12, 8
SERVE_CACHE = 48         # decode slots: no other dim of the reduced
                         # configs is 48, so a full-length cache shows
SERVE_FRAMES, SERVE_PREFIX = 16, 8   # seamless' frames, pixtral's rows


def serve_batch(cfg, seed: int = 3) -> dict:
    """A prefill batch as numpy arrays: SERVE_ROWS prompts of SERVE_PROMPT
    tokens, after an 8-row prefix (pixtral) or over 16 encoder frames
    (seamless)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (SERVE_ROWS, SERVE_PROMPT)).astype(
                                      np.int32)}
    if cfg.is_encdec:
        out["enc_embeds"] = (rng.standard_normal(
            (SERVE_ROWS, SERVE_FRAMES, cfg.d_model)) * 0.5).astype(
                np.float32)
    elif cfg.embed_stub:
        out["embeds"] = (rng.standard_normal(
            (SERVE_ROWS, SERVE_PREFIX, cfg.d_model)) * 0.5).astype(
                np.float32)
    return out


def serve_prompt_len(cfg) -> int:
    return SERVE_PROMPT + (SERVE_PREFIX if cfg.embed_stub else 0)


def serve_one_device(cfg, params, batch, cache_len=SERVE_CACHE) -> dict:
    """The port's unsharded serving steps: the greedy prefill, its logits
    and natural caches, `prefill_into_cache` into `cache_len` slots, then
    SERVE_STEPS greedy decode steps (tokens, and logits a step from a
    second call on a copy of the cache) and the final caches."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import step as ST
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         batch.items()}
    with torch.no_grad():
        logits, nat = ST.build_prefill(cfg, return_logits=True)(params, t)
        tok = ST.build_prefill(cfg)(params, t)[0]
        n = serve_prompt_len(cfg)
        empty = T.init_cache(cfg, SERVE_ROWS, cache_len, device="cpu",
                             enc_len=SERVE_FRAMES if cfg.is_encdec else 0)
        # the handoff takes a recurrent state as it is: keep the prefill's
        cache = ST.prefill_into_cache(cfg, tree_map(torch.clone, nat),
                                      empty, torch.full((SERVE_ROWS,), n))
        handed = tree_map(torch.clone, cache)
        greedy = ST.build_decode(cfg)
        with_logits = ST.build_decode(cfg, return_logits=True)
        toks, step_logits = [tok], [logits]
        for i in range(SERVE_STEPS):
            pos = torch.full((SERVE_ROWS,), n + i, dtype=torch.int32)
            # on a copy: a recurrent state steps again at every call
            step_logits.append(with_logits(params, tok[:, None], pos,
                                           tree_map(torch.clone, cache))[0])
            tok = greedy(params, tok[:, None], pos, cache)[0]
            toks.append(tok)
    return {"tokens": torch.stack(toks), "logits": torch.stack(step_logits),
            "prefill_caches": nat, "handed": handed, "caches": cache,
            "cache_len": cache_len}


def serve_ranks(rank, world, params_path, archs, mesh_shape, names,
                cache_lens=None):
    """On a mesh of `mesh_shape` / `names`, for each arch of `archs` (its
    bridged params pickled at `params_path`): the tensor-parallel prefill
    (greedy and with logits), `prefill_into_cache_split` into
    `cache_lens[arch]` slots (default SERVE_CACHE), SERVE_STEPS greedy
    decode steps from the ranks' own tokens (each step's logits too, from
    a second call on the same inputs and a copy of the cache: a
    recurrent state would step twice); the all-reduces of every call, the shapes of every op output
    of the greedy calls and the handoff, the local cache shapes, and (rank
    0) every cache gathered."""
    import pickle
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import registry
    from repro_torch.launch import distributed as D
    from repro_torch.models import transformer as T
    from repro_torch.serve import step as ST
    from repro_torch.sharding import rules as R
    from repro_torch.sharding import spmd
    from repro_torch.sharding import tp as TP
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
    with open(params_path, "rb") as f:
        bridged = pickle.load(f)
    logits_shapes, plain_logits = [], T._logits

    def recorded_logits(*a, **k):       # the logits a rank computes
        o = plain_logits(*a, **k)
        logits_shapes.append(tuple(o.shape))
        return o
    T._logits = recorded_logits
    out = {}
    for arch in archs:
        logits_shapes.clear()
        cfg = registry.get(arch, reduced=True)
        tp = TP.TensorParallel.build(cfg, mesh)
        params = R.distribute(mesh, bridged[arch],
                              R.param_specs(cfg, bridged[arch], mesh))
        batch = serve_batch(cfg)
        dbatch = D.put_batch(mesh, R.batch_specs(cfg, batch, mesh), batch)
        n = serve_prompt_len(cfg)
        tok_spec = R.P(R.batch_axes(mesh))
        p_specs = R.prefill_cache_specs(cfg, prefill_cache_shapes(cfg), mesh)
        out_p = (tok_spec, p_specs)
        local_p = TP.prefill_local_specs(out_p, tp)
        cache_len = (cache_lens or {}).get(arch, SERVE_CACHE)
        res = {"split": (tp.heads, tp.kv, tp.vocab, tp.experts, tp.lru,
                         tp.ssm), "cache_len": cache_len}
        counts = {}

        def run(name, fn, args, specs, local=None, shapes=None):
            before = (tp.all_reduces, tp.all_to_alls)
            with torch.no_grad(), ShapeRecorder(
                    [] if shapes is None else shapes):
                o = spmd.call_split(fn, args, specs, tp, local)
            counts.setdefault(name, []).append(
                (tp.all_reduces - before[0], tp.all_to_alls - before[1]))
            return o
        shapes = {"prefill": [], "decode": [], "handoff": []}
        logits, nat = run("prefill_logits",
                          ST.build_prefill(cfg, return_logits=True, tp=tp),
                          (params, dbatch), out_p, local_p)
        tok, nat = run("prefill", ST.build_prefill(cfg, tp=tp),
                       (params, dbatch), out_p, local_p, shapes["prefill"])
        # the caches' move to head_dim by the all-reduce route (the card
        # rig's: gloo runs no all-to-all on CUDA tensors)
        tp.runs_all_to_all = lambda x: False
        _, nat_ar = run("prefill_all_reduce_route",
                        ST.build_prefill(cfg, tp=tp), (params, dbatch),
                        out_p, local_p)
        del tp.runs_all_to_all
        nat_ar = spmd_full(nat_ar)
        cache_g = T.init_cache(cfg, SERVE_ROWS, cache_len, device="cpu",
                               enc_len=SERVE_FRAMES if cfg.is_encdec else 0)
        c_specs = R.cache_specs(cfg, cache_g, mesh)
        cache = R.distribute(mesh, cache_g, c_specs)
        before = tp.all_reduces
        with torch.no_grad(), ShapeRecorder(shapes["handoff"]):
            ST.prefill_into_cache_split(cfg, nat, cache,
                                        torch.full((SERVE_ROWS,), n), tp)
        counts["handoff"] = [(tp.all_reduces - before, 0)]
        full = spmd_full(nat), spmd_full(cache)   # collectives: every rank
        res["prefill_caches"], res["handed"] = full if rank == 0 else (None,
                                                                       None)
        res["all_reduce_route_equal"] = all(
            torch.equal(a, b) for a, b in zip(tree_leaves(nat_ar),
                                              tree_leaves(full[0])))
        split = TP.cache_split(c_specs)
        greedy = ST.build_decode(cfg, tp=tp, split=split)
        with_logits = ST.build_decode(cfg, return_logits=True, tp=tp,
                                      split=split)
        pspec = R.P(R.batch_specs(cfg, {"t": tok[:, None]}, mesh)["t"][0])
        toks, step_logits = [tok.full_tensor()], [logits.full_tensor()]
        for i in range(SERVE_STEPS):
            pos = D.put_batch(mesh, {"p": pspec}, {"p": torch.full(
                (SERVE_ROWS,), n + i, dtype=torch.int32)})["p"]
            t_in = D.put_batch(mesh, {"t": R.P(pspec[0], None)},
                               {"t": toks[-1][:, None]})["t"]
            lg, _ = run("decode_logits", with_logits,
                        (params, t_in, pos, tree_map(torch.clone, cache)),
                        (pspec, c_specs))
            tok, cache = run("decode", greedy, (params, t_in, pos, cache),
                             (pspec, c_specs), None,
                             shapes["decode"] if i == 0 else None)
            step_logits.append(lg.full_tensor())
            toks.append(tok.full_tensor())
        full = None, spmd_full(cache)
        res.update({
            "tokens": torch.stack(toks), "logits": torch.stack(step_logits),
            "caches": full[1] if rank == 0 else None,
            "counts": counts,
            "shapes": {k: sorted(set(v)) for k, v in shapes.items()},
            "logits_shapes": sorted(set(logits_shapes)),
            "local_cache": [{k: tuple(spmd.local(x).shape) for k, x in
                             c.items()} for c in cache],
            "cache_split": split})
        out[arch] = res
    return out


def prefill_cache_shapes(cfg) -> list:
    """The prefill's natural-length caches of `serve_batch` as meta
    tensors."""
    from repro_torch.models import transformer as T
    caches = T.init_cache(cfg, SERVE_ROWS, serve_prompt_len(cfg),
                          device="meta",
                          enc_len=SERVE_FRAMES if cfg.is_encdec else 0)
    for c in caches:            # the prefill emits no cross positions
        c.pop("cross_pos", None)
    return caches


def spmd_full(tree):
    """Every DTensor leaf gathered whole, a copy (a leaf replicated over
    the mesh gives its local tensor itself, which a later in-place step
    would write)."""
    return tree_map(lambda x: x.full_tensor().clone()
                    if hasattr(x, "full_tensor") else x, tree)


# ------------------------------------------------------------ decode read

READ_CASES = ("full", "ring", "empty_rank", "rows", "whole", "cross")
READ_ROWS = 4
# (cache slots, each row's position, window): a linear cache filled below
# each position; a ring of 16 under a window of 12, every slot holding one
# of the last 16 positions; every slot past 8 empty (ranks 1.. of 2 and 4
# hold nothing); only rows 0 and 2 written; 31 slots, which 2 and 4 do not
# divide (the read runs whole); a cross cache, 16 frames with the rows'
# first 16, 10, 5, 16 valid
READ_SHAPES = {"full": (32, (5, 17, 31, 20), None),
               "ring": (16, (40, 23, 57, 16), 12),
               "empty_rank": (32, (3, 1, 6, 0), None),
               "rows": (32, (5, 17, 31, 20), None),
               "whole": (31, (5, 17, 30, 20), None),
               "cross": (16, (16, 10, 5, 16), None)}


def read_inputs(case: str, seed: int = 4) -> dict:
    """Reduced qwen3-1.7b's attention weights (4 heads, 2 kv heads, qk-norm)
    and a decode token with its cache, as numpy arrays: keys and values
    drawn at every slot, positions per READ_SHAPES (-1 where empty)."""
    cfg = attn_config("attention")
    inp = operator_inputs("attention", seed)
    rng = np.random.default_rng(seed + 1)
    n, pos, _ = READ_SHAPES[case]
    nkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    slot_pos = np.full((READ_ROWS, n), -1, np.int32)
    for b, p in enumerate(pos):
        if case == "cross":
            slot_pos[b, :p] = np.arange(p)
        elif case == "ring":
            for q in range(p - n, p):
                slot_pos[b, q % n] = q
        else:
            slot_pos[b, :p] = np.arange(p)
    return {**{k: inp[k] for k in ("wq", "wk", "wv", "wo", "q_norm",
                                    "k_norm")},
            "x": rng.standard_normal((READ_ROWS, 1, cfg.d_model)).astype(
                np.float32),
            "k": rng.standard_normal((READ_ROWS, n, nkv, hd)).astype(
                np.float32),
            "v": rng.standard_normal((READ_ROWS, n, nkv, hd)).astype(
                np.float32),
            "cache_pos": slot_pos, "pos": np.asarray(pos, np.int32)}


def run_read(case: str, inp: dict, tp=None) -> dict:
    """`layers.attention_decode` of one case, on one device (tp=None) or
    with `tp` on this rank's weights and, where the ranks divide the
    slots, its slice of the cache. Returns the output, the cache (the
    rank's slice) after the write, whether it was split and the
    all-reduces."""
    from repro_torch.models import layers as L
    cfg = attn_config("attention")
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         inp.items()}
    n, _, window = READ_SHAPES[case]
    r, k = (0, 1) if tp is None else (tp.rank, tp.size)
    split = tp is not None and n % k == 0
    kv_split = tp is None or tp.kv
    p = {"wq": _cols(t["wq"], r, k),
         "wk": _cols(t["wk"], r, k) if kv_split else t["wk"],
         "wv": _cols(t["wv"], r, k) if kv_split else t["wv"],
         "wo": _rows(t["wo"], r, k),
         "q_norm": {"scale": t["q_norm"]}, "k_norm": {"scale": t["k_norm"]}}
    sl = slice(r * n // k, (r + 1) * n // k) if split else slice(None)
    ck, cv, cp = (t[name][:, sl].clone() for name in ("k", "v", "cache_pos"))
    rows = torch.tensor([0, 2]) if case == "rows" else None
    before = 0 if tp is None else tp.all_reduces
    with torch.no_grad():
        out, ck, cv, cp = L.attention_decode(
            p, cfg, t["x"], t["pos"], ck, cv, cp, window=window,
            rope=case != "cross", rows=rows, cross=case == "cross", tp=tp,
            split=split)
    return {"out": out, "k": ck, "v": cv, "pos": cp, "split": split,
            "all_reduces": 0 if tp is None else tp.all_reduces - before}


def read_ranks(rank, world, cases):
    """Every decode read case on a ("model",) mesh of all the ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.sharding.tp import TensorParallel
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    tp = TensorParallel.build(attn_config("attention"), mesh)
    return {case: dict(run_read(case, read_inputs(case), tp), kv=tp.kv)
            for case in cases}
