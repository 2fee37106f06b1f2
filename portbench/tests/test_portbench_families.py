"""A configuration's model side is the family module it names
(`families/<name>.py`). The decoder family reproduces, bit for bit, the
weights, reference logits, counts and readings that the harness gave
before the model side was looked up by family (the literals below were
recorded from that tree); a family that exists only as a new file runs a
cell end to end; a missing family or hook is refused."""
import hashlib
import json
from types import SimpleNamespace

import pytest
import torch

from _portbench_fixture import (CELL, ROOT, make_root, tiny_mix, tiny_model,
                                tree_hashes)
from portbench import isolation, model, session, spec, weights

DECODER = spec.family("decoder")
CONFIGS = ("granite-moe-3b-a800m", "mistral-nemo-12b")
POSITIONS = (0, 2047, 4351)
PREFILLS = ((0, 2048), (4000, 64))
READERS = ("mfu.decode", "mfu.prefill", "paged_attn.roofline")


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def digest(tensors) -> str:
    h = hashlib.sha256()
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)};".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def published(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" /
                       f"{name}.json").read_text())["model"]


WEIGHTS = {
    "moe-float32-3": "69de863679352fd33a0a7866eec980550b83faf2fe999af34caa3ae49b05cfec",
    "moe-float32-2147483689": "4049c3e7a4f70dc3e46ffcccb277cd302a0cef4bd02b82255ed770dd326d3858",
    "moe-bfloat16-3": "a126be435e883477a7c5012c8d4a426aada2ac6d17475bd1a5b1cf62728bbd55",
    "moe-bfloat16-2147483689": "89fb5c5ee88a794828529bddd6a9f59220291d1bde6e47baacae89ed1dba02be",
    "dense-float32-3": "bd4027738d6f1f3e9c5e51dcab59af09d2fe14f41b93625162dfeb899e204458",
    "dense-float32-2147483689": "f006f0fb94c81b75a5430671fbb8b0e9b185af3cf407388de79f160fb1ccedbe",
    "dense-bfloat16-3": "d9df774d04345a2f73e53660dc591a2d055ae051de0efa8c04bffe3d4363494a",
    "dense-bfloat16-2147483689": "f14ff912ed698b0bd5956973a940f3476ad57aa1239d6fecbb6204270a1b9d1c",
}


@pytest.mark.parametrize("key", sorted(WEIGHTS))
def test_weights_are_the_pinned_draws(key):
    kind, dtype, seed = key.split("-")
    m = tiny_model(kind == "moe")
    m["param_dtype"] = dtype
    w = weights.make(m, int(seed), torch.device("cpu"), DECODER)
    assert digest(w) == WEIGHTS[key]


@pytest.mark.parametrize("kind", ("moe", "dense"))
def test_a_caller_naming_no_family_gets_the_decoder(kind):
    # as tools/probe_regions.py calls them: weights.make(m, seed, device),
    # model.program_params(w, m, cfg)
    m = tiny_model(kind == "moe")
    w = weights.make(m, 3, torch.device("cpu"))
    assert digest(w) == WEIGHTS[f"{kind}-float32-3"]
    cfg = model.model_config(m)
    got = model.program_params(w, m, cfg)
    want = model.program_params(w, m, cfg, DECODER)
    flat = torch.utils._pytree.tree_leaves
    assert [t.data_ptr() for t in flat(got)] == [
        t.data_ptr() for t in flat(want)]
    assert [t.shape for t in flat(got)] == [t.shape for t in flat(want)]


LOGITS = {
    "moe-None": "f2809ab7277f596c1fbd55fa432d09c7edc96c4fae118815a6dc59d610cbed19",
    "moe-fp8": "ab149cc4bd1f6c9696eda2f7f998e27d90700f6c93398c4e91246639911be266",
    "dense-None": "1fbf689dcfe5ce3b27f31175daa51d74238b21a8c10420fbb41fe50c1aaa0209",
    "dense-fp8": "1a1636f30324b4686f2f41543f79023f3c97aca74132f6a7f5f17bea63b3e3a9",
}


@pytest.mark.parametrize("key", sorted(LOGITS))
def test_reference_and_control_logits_are_the_pinned_values(key):
    kind, quant = key.split("-")
    m = tiny_model(kind == "moe")
    w = weights.make(m, 3, torch.device("cpu"), DECODER)
    toks = [(7 * i + 3) % 509 + 2 for i in range(40)]
    # a 25-token prompt: an MoE dispatch group of 32 with capacity drops
    r = SimpleNamespace(prompt=toks[:25], tokens=toks[25:])
    got = DECODER.reference_logits(w, m, tiny_mix(), r,
                                   quant=None if quant == "None" else quant)
    assert digest({"logits": got}) == LOGITS[key]


COUNTS = {
    "granite-moe-3b-a800m": {
        "decode": [1765745664, 2168202240, 2621187072],
        "decode_all": 6555134976,
        "prefill": [3719257138176, 154222470144],
        "paged": [262400, 134430848, 285444224]},
    "mistral-nemo-12b": {
        "decode": [23153213440, 24494735360, 26004684800],
        "decode_all": 73652633600,
        "prefill": [46044062679040, 1566341857280],
        "paged": [819520, 336220320, 713730720]},
}


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_of_the_published_configs_are_the_pinned_values(name):
    m = published(name)
    got = {"decode": [DECODER.decode_flops(m, [p]) for p in POSITIONS],
           "decode_all": DECODER.decode_flops(m, POSITIONS),
           "prefill": [DECODER.prefill_flops(m, s, n) for s, n in PREFILLS],
           "paged": [DECODER.paged_read_bytes(m, p, 16) for p in POSITIONS]}
    assert got == COUNTS[name]


def reader_record(m: dict) -> dict:
    spans = [("engine.step", 0.0, 0.125, {"step": "prefill", "prompt_len": 40,
                                          "reused": 0}),
             ("engine.step", 0.25, 0.3125, {"step": "prefill",
                                            "prompt_len": 60, "reused": 32}),
             ("engine.step", 0.5, 0.75, {"step": "fused"}),
             ("engine.step", 0.75, 0.8, {"step": "fused"}),
             ("engine.step", 0.9, 0.95, {"step": "single"})]
    prof = {"window": (0.0, 1.0), "labels": [],
            "ops": [("paged_attention_split<bf16>", 0.1, 0.3),
                    ("paged_attention_combine<bf16>", 0.25, 0.35),
                    ("gemm", 0.5, 0.6)]}
    return {"model": m, "mix": {"block_size": 16}, "window_s": 1.0,
            "spans": spans, "gateway_steps": [(0.0, 0.95)],
            "fused": [{"profiled": True,
                       "slots": [(39, 8), (59, 8), (70, 3)]},
                      {"profiled": False, "slots": [(47, 8)]}],
            "single": [{"profiled": True, "slots": [(50, 1), (99, 1)]}],
            "profile": prof, "family": DECODER,
            "cache": {"start": {"tokens_reused": 0, "tokens_computed": 0},
                      "end": {"tokens_reused": 0, "tokens_computed": 0}}}


READINGS = {
    "tiny-moe": (1.7563653522076168e-06, 4.298936299292215e-06,
                 7.743617910447762e-05),
    "tiny-dense": (1.9706909336029656e-06, 5.162589012470509e-06,
                   7.743617910447762e-05),
    "granite-moe-3b-a800m": (0.01616501206066734, 0.05959326642345804,
                             0.010064819582089555),
    "mistral-nemo-12b": (0.2110184099764071, 0.801984993801146,
                         0.02557084656716418),
}


@pytest.mark.parametrize("key", sorted(READINGS))
def test_readers_give_the_pinned_values(key):
    m = (tiny_model(key == "tiny-moe") if key.startswith("tiny")
         else published(key))
    got = tuple(spec.metric_reader(r)(reader_record(m)) for r in READERS)
    assert got == READINGS[key]


COUNTING = '''
"""Test only: the decoder family, writing each hook's name per call."""
from pathlib import Path

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]
_DECODER = spec.family("decoder", ROOT)


def _counted(name):
    def hook(*a, **kw):
        with (ROOT / "family.calls").open("a") as f:
            f.write(name + "\\n")
        return getattr(_DECODER, name)(*a, **kw)
    return hook


for _name in spec.FAMILY_FUNCTIONS:
    globals()[_name] = _counted(_name)
'''


def test_a_new_family_runs_a_cell_as_a_new_file_only(tmp_path):
    root = make_root(tmp_path, family="counting")
    (root / "portbench" / "families" / "counting.py").write_text(COUNTING)
    before = tree_hashes(ROOT / "portbench")
    copied = tree_hashes(root / "portbench")
    assert {k: v for k, v in copied.items() if k in before} == before
    assert set(copied) - set(before) == {
        "configs/tiny.json", "traffic/tiny.json", f"limits/{CELL}.json",
        "families/counting.py"}
    cell = spec.find_cell(spec.load_benchmark(root), CELL, root)
    out = session.run_cell(cell, 2 ** 31 + 5, 3.0, True, "cpu")
    assert out["correct"], out["checks"]
    calls = set((root / "family.calls").read_text().split())
    assert calls == set(spec.FAMILY_FUNCTIONS)
    # no paged-attention kernel runs on the CPU: the roofline reads nothing
    for name in ("mfu.decode", "mfu.prefill"):
        assert out["metrics"][name]["value"] > 0


def test_an_unknown_family_or_a_missing_hook_is_refused(tmp_path):
    root = make_root(tmp_path, family="no-such-family")
    with pytest.raises(spec.SpecError, match="no-such-family"):
        spec.find_cell(spec.load_benchmark(root), CELL, root)
    fam = root / "portbench" / "families"
    src = (fam / "decoder.py").read_text()
    (fam / "partial.py").write_text(
        src.replace("def paged_read_bytes(", "def _paged_read_bytes("))
    with pytest.raises(spec.SpecError, match="paged_read_bytes"):
        spec.family("partial", root)
    config = json.loads((root / "portbench/configs/tiny.json").read_text())
    del config["harness_family"]
    (root / "portbench/configs/tiny.json").write_text(json.dumps(config))
    with pytest.raises(spec.SpecError, match="harness_family"):
        spec.find_cell(spec.load_benchmark(root), CELL, root)


@pytest.mark.parametrize("name", CONFIGS)
def test_each_published_config_names_the_decoder_family(name):
    path = ROOT / "portbench" / "configs" / f"{name}.json"
    assert json.loads(path.read_text())["harness_family"] == "decoder"


def test_the_program_config_takes_any_nested_group():
    from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
    for name in CONFIGS:
        m = published(name)
        moe = m.get("moe")
        want = ModelConfig(**{k: v for k, v in m.items() if k != "moe"},
                           moe=MoEConfig(**moe) if moe else None)
        assert model.model_config(m) == want
    m = dict(tiny_model(False), family="hybrid",
             block_pattern=["ssm", "attn"],
             ssm={"d_state": 16, "head_dim": 16, "chunk_size": 8})
    cfg = model.model_config(m)
    assert cfg.block_pattern == ("ssm", "attn")
    assert cfg.ssm == SSMConfig(d_state=16, head_dim=16, chunk_size=8)


def test_a_family_imports_nothing_of_the_program():
    for path in sorted((ROOT / "portbench" / "families").glob("*.py")):
        names = isolation.imports(path)
        assert not [n for n in names if isolation.forbidden(n)
                    or n.split(".")[0] == "repro_torch"], path
