"""The port's sharding rule engine (`repro_torch.sharding.rules`) against
the reference's (`repro.sharding.rules`), spec for spec.

The reference's spec functions read only a mesh's axis names and shape,
so both packages get mesh stand-ins here: the reference a namespace with
`axis_names` and `devices` (an empty object array of the mesh's shape),
the port `rules.mesh_like`. No devices, no process group. Every leaf's
spec must be equal, entry for entry, to `tuple(reference PartitionSpec)`;
a port layer leaf is compared with its stacked reference leaf's spec minus
the leading (n_blocks) entry.
"""
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import shapes as JS  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import shapes as TS  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402

MESHES = {
    "debug": ((2, 2), ("data", "model")),
    "debug-pod2": ((2, 2, 2), ("pod", "data", "model")),
    "prod": ((16, 16), ("data", "model")),
    "prod-pod2": ((2, 16, 16), ("pod", "data", "model")),
}
ARCHS = jreg.ARCH_IDS


def meshes(name):
    shape, axes = MESHES[name]
    ref = SimpleNamespace(axis_names=axes,
                          devices=np.empty(shape, dtype=object))
    return ref, R.mesh_like(shape, axes)


def ref_flat(tree):
    """{"/"-joined reference path: spec tuple}."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(JR._pkey(p) for p in path): tuple(s)
            for path, s in flat}


def check_params(tcfg, port_specs, ref_specs):
    ref = ref_flat(ref_specs)
    n = 0
    for path, spec in R._walk(port_specs):
        pstr, lead = R.reference_path(path, tcfg)
        want = ref[pstr][1:] if lead else ref[pstr]
        assert spec == want, (pstr, spec, want)
        n += 1
    assert n == len(ref) or tcfg.n_blocks > 1 or tcfg.n_enc_layers > 1
    return n


def check_caches(tcfg, port_specs, ref_specs):
    """The port's per-layer cache specs against the reference's
    {"blocks": stacked, "tail": ...} tree."""
    ref = ref_flat(ref_specs)
    n_pat = len(tcfg.block_pattern)
    n_scan = tcfg.n_blocks * n_pat
    for li, layer in enumerate(port_specs):
        for k, spec in layer.items():
            if li < n_scan:
                want = ref[f"blocks/{li % n_pat}/{k}"][1:]
            else:
                want = ref[f"tail/{li - n_scan}/{k}"]
            assert spec == want, (li, k, spec, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dryrun", [False, True], ids=["plain", "dryrun"])
def test_param_and_opt_specs_match_reference(arch, mesh, dryrun):
    """Full-size configs: param_specs and opt_state_specs, leaf by leaf."""
    jm, tm = meshes(mesh)
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    if dryrun:
        jcfg, tcfg = JS.dryrun_config(jcfg), TS.dryrun_config(tcfg)
    jspecs = JR.param_specs(jcfg, JS.params_shapes(jcfg), jm)
    tshapes = TS.params_shapes(tcfg)
    tspecs = R.param_specs(tcfg, tshapes, tm)
    check_params(tcfg, tspecs, jspecs)
    from repro_torch.optim import adamw
    ostate = adamw(1e-3)[0](tshapes)
    ospecs = R.opt_state_specs(tcfg, ostate, tspecs)
    assert ospecs.step == ()
    assert ospecs.mu is tspecs and ospecs.nu is tspecs


@pytest.fixture
def small_shapes(monkeypatch):
    """Both packages' SHAPES cut to 64 tokens x 8 rows (the reference's
    own reduced-case cut)."""
    for mod in (JS, TS):
        for name, c in list(mod.SHAPES.items()):
            monkeypatch.setitem(mod.SHAPES, name,
                                mod.ShapeCase(c.name, c.kind, 64, 8))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_case_specs_match_reference(small_shapes, arch, shape, mesh):
    """Reduced configs at 64 x 8: every in/out spec tree of make_case
    (params, AdamW state and batch for train; batch and the prefill-cache
    layout for prefill; tokens, positions and the decode-cache layout for
    decode)."""
    jm, tm = meshes(mesh)
    jcfg, tcfg = jreg.get(arch, reduced=True), treg.get(arch, reduced=True)
    jc = JS.make_case(jcfg, shape, jm, microbatches=2)
    tc = TS.make_case(tcfg, shape, tm, microbatches=2)
    dcfg = tc["meta"]["cfg"]
    check_params(dcfg, tc["in_specs"][0], jc["in_specs"][0])
    kind = TS.SHAPES[shape].kind
    if kind == "train":
        jo, to = jc["in_specs"][1], tc["in_specs"][1]
        assert to.step == tuple(jo[0])
        check_params(dcfg, to.mu, jo[1])
        check_params(dcfg, to.nu, jo[2])
        assert tc["in_specs"][2] == {k: tuple(v)
                                     for k, v in jc["in_specs"][2].items()}
        assert {k: v for k, v in tc["out_specs"][2].items()} == {
            k: tuple(v) for k, v in jc["out_specs"][2].items()}
    elif kind == "prefill":
        assert tc["in_specs"][1] == {k: tuple(v)
                                     for k, v in jc["in_specs"][1].items()}
        assert tc["out_specs"][0] == tuple(jc["out_specs"][0])
        check_caches(dcfg, tc["out_specs"][1], jc["out_specs"][1])
    else:
        for i in (1, 2):
            assert tc["in_specs"][i] == tuple(jc["in_specs"][i])
        check_caches(dcfg, tc["in_specs"][3], jc["in_specs"][3])
        assert tc["meta"]["cache_len"] == jc["meta"]["cache_len"]
        assert tc["meta"]["window"] == jc["meta"]["window"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mistral-nemo-12b",
                                  "mamba2-130m", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_long_context_cache_specs_match_reference(small_shapes, monkeypatch,
                                                  arch, mesh):
    """long_500k (batch 1: every batch fallback) keeps its 500k position so
    the sliding-window cache length rule applies."""
    for mod in (JS, TS):
        monkeypatch.setitem(mod.SHAPES, "long_500k",
                            mod.ShapeCase("long_500k", "decode", 524_288, 1))
    jm, tm = meshes(mesh)
    jcfg, tcfg = jreg.get(arch, reduced=True), treg.get(arch, reduced=True)
    jcfg = jcfg.replace(long_context_window=32)
    tcfg = tcfg.replace(long_context_window=32)
    jc = JS.make_case(jcfg, "long_500k", jm)
    tc = TS.make_case(tcfg, "long_500k", tm)
    check_caches(tc["meta"]["cfg"], tc["in_specs"][3], jc["in_specs"][3])
    assert tc["in_specs"][1] == tuple(jc["in_specs"][1])
    assert tc["meta"] == {**{k: v for k, v in jc["meta"].items()
                             if k != "cfg"}, "cfg": tc["meta"]["cfg"]}


# ------------------------------------------ the reference's own rule cases

def flat_port(tcfg, specs):
    return {R.reference_path(p, tcfg)[0] + (f"#{p[1]}" if p[0] == "layers"
                                           else ""): s
            for p, s in R._walk(specs)}


def test_param_specs_divisibility_rules():
    _, mesh = meshes("debug")
    cfg = treg.get("qwen3-1.7b")
    flat = flat_port(cfg, R.param_specs(cfg, TS.params_shapes(cfg), mesh))
    assert flat["embed/table"] == ("model", None)
    wq = [v for k, v in flat.items() if "attn/wq" in k]
    assert wq and all(s == (None, "model") for s in wq)
    wo = [v for k, v in flat.items() if "attn/wo" in k]
    assert wo and all(s == ("model", None) for s in wo)
    norms = [v for k, v in flat.items() if "norm" in k]
    assert norms and all(all(a is None for a in s) for s in norms)


@pytest.mark.parametrize("arch,mesh,want", [
    # 32 experts % 2 == 0 -> expert-parallel
    ("granite-moe-1b-a400m", "debug", ("model", None, None)),
    # granite-3b's 40 experts % 16 != 0 -> expert-internal TP on d_ff
    ("granite-moe-3b-a800m", "prod", (None, None, "model")),
    # ... unless the dry-run pads them to 48
    ("granite-moe-3b-a800m-padded", "prod", ("model", None, None)),
])
def test_moe_expert_parallel_vs_internal_tp(arch, mesh, want):
    _, m = meshes(mesh)
    cfg = treg.get(arch.replace("-padded", ""))
    if arch.endswith("-padded"):
        cfg = TS.dryrun_config(cfg)
    flat = flat_port(cfg, R.param_specs(cfg, TS.params_shapes(cfg), m))
    gates = [v for k, v in flat.items() if "ffn/w_gate" in k]
    assert gates and all(s == want for s in gates)


@pytest.mark.parametrize("mesh,rows,want", [
    ("debug", 8, ("data", None)),
    ("debug", 3, (None, None)),                 # indivisible -> replicate
    ("debug-pod2", 8, (("pod", "data"), None)),
    ("debug-pod2", 2, ("data", None)),          # pod x data does not divide
    ("prod-pod2", 16, ("data", None)),
    ("prod-pod2", 1, (None, None)),
])
def test_batch_specs_fallbacks(mesh, rows, want):
    jm, tm = meshes(mesh)
    cfg = treg.get("qwen3-1.7b")
    import torch
    t = {"tokens": torch.empty((rows, 16), dtype=torch.int32, device="meta")}
    assert R.batch_specs(cfg, t, tm)["tokens"] == want
    j = {"tokens": jax.ShapeDtypeStruct((rows, 16), np.int32)}
    assert tuple(JR.batch_specs(jreg.get("qwen3-1.7b"), j, jm)["tokens"]) \
        == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_helpers_match_reference(mesh):
    jm, tm = meshes(mesh)
    assert R.batch_axes(tm) == JR.batch_axes(jm)
    assert R.dp_size(tm) == JR.dp_size(jm)
    for a in ("pod", "data", "model", "absent"):
        assert R.mesh_axis_size(tm, a) == JR.mesh_axis_size(jm, a)


# ------------------------------------------ the reference's config cases

def test_decode_cache_lengths():
    # full attention at 32k -> full cache; at 500k -> sliding window variant
    nemo = TS.dryrun_config(treg.get("mistral-nemo-12b"))
    assert TS.decode_cache_len(nemo, TS.SHAPES["decode_32k"]) == 32768
    assert TS.decode_cache_len(nemo, TS.SHAPES["long_500k"]) == 4096
    # native window arch keeps its window everywhere
    rg = TS.dryrun_config(treg.get("recurrentgemma-9b"))
    assert TS.decode_cache_len(rg, TS.SHAPES["decode_32k"]) == 2048
    assert TS.decode_cache_len(rg, TS.SHAPES["long_500k"]) == 2048


def test_dryrun_config_padding_rules():
    g = TS.dryrun_config(treg.get("granite-moe-3b-a800m"))
    assert g.padded_vocab_size % 256 == 0
    assert g.moe.padded_n_experts == 48
    assert not g.seq_parallel            # MoE: SP gated off
    q = TS.dryrun_config(treg.get("qwen3-4b"))
    assert q.seq_parallel
    m = TS.dryrun_config(treg.get("mamba2-130m"))
    assert not m.seq_parallel


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_tables_and_dryrun_config_match_reference(arch):
    assert {k: tuple(vars(v).values()) for k, v in TS.SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in JS.SHAPES.items()}
    assert TS.TRAIN_MICROBATCHES == JS.TRAIN_MICROBATCHES
    j = JS.dryrun_config(jreg.get(arch))
    t = TS.dryrun_config(treg.get(arch))
    for f in ("vocab_pad_to", "seq_parallel", "dtype", "param_dtype",
              "padded_vocab_size"):
        assert getattr(t, f) == getattr(j, f), f
    if j.moe:
        assert t.moe.padded_n_experts == j.moe.padded_n_experts
    for name in TS.SHAPES:
        assert TS.decode_cache_len(t, TS.SHAPES[name]) == \
            JS.decode_cache_len(j, JS.SHAPES[name])
        assert TS.decode_window(t, TS.SHAPES[name]) == \
            JS.decode_window(j, JS.SHAPES[name])


# ------------------------------------------ constrain

def test_constrain_without_mesh_returns_its_input():
    import torch
    x = torch.ones(4, 8, 16)
    assert R.constrain(x, ("batch", None, "model")) is x
    with R.mesh_context(R.mesh_like((2, 2), ("data", "model"))):
        assert R.constrain(x, ("batch", None, "model")) is x  # no DTensor
