"""The comparison that decides `correct`: the reference against the
program on a tiny model, the float8 control reading above the limit, and
whole runs on the CPU with the timed path broken underneath coming out
not correct (the faults a one-chip serving cell can have; a cell on one
chip has no exchange between chips to leave out)."""
import pytest
import torch

from _portbench_fixture import tiny_cell, tiny_model
from portbench import check, model, session, spec, weights
from portbench.reference import lm

SEED = 2 ** 31 + 41


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _program(m):
    fam = spec.family("decoder")
    w = weights.make(m, 3, torch.device("cpu"), fam)
    cfg = model.model_config(m)
    return w, cfg, model.program_params(w, m, cfg, fam)


@pytest.mark.parametrize("moe", [False, True])
def test_reference_equals_the_programs_prefill(moe):
    from repro_torch.models import transformer as T
    m = tiny_model(moe)
    if moe:      # no drops here: every entry is kept on both sides
        m["moe"]["capacity_factor"] = 100.0
    w, cfg, params = _program(m)
    toks = torch.randint(2, m["vocab_size"], (40,)).tolist()
    cache = T.init_paged_cache(cfg, 5, 16, "cpu")
    table = torch.tensor([1, 2, 3], dtype=torch.int32)
    want, _ = T.forward_prefill_paged(params, cfg, torch.tensor([toks]), 0,
                                      40, cache, table)
    got = lm.logits(w, m, toks, 25, 64)
    torch.testing.assert_close(got, want[0, 24:40], rtol=1e-4, atol=1e-4)


def test_reference_moe_drops_as_the_program_does():
    from repro_torch.models import moe as MOE
    m = tiny_model(True)
    m["moe"]["capacity_factor"] = 0.5
    w, cfg, params = _program(m)
    h = torch.randn(1, 32, m["d_model"])
    want, _ = MOE.moe_ffn(params["layers"][0]["ffn"], cfg, h)
    got = lm._moe(h[0], m, lm.layer_weights(w, m, 0), lm._Precision(None),
                  32, 32)
    torch.testing.assert_close(got, want[0], rtol=1e-5, atol=1e-5)
    # the capacity bites: fewer slots than entries per expert
    assert lm.capacity(m, 32) * m["moe"]["n_experts"] < 32 * 2


def test_bucket_rule():
    assert [check.bucket(n, 128) for n in (1, 16, 17, 100, 128)] == \
        [1, 16, 32, 128, 128]
    assert check.bucket(200, 128) == 200 and check.bucket(300, 4352) == 512
    assert check.bucket(4096, 4352) == 4096


def test_a_sound_run_is_correct_and_the_control_is_not(tmp_path):
    cell = tiny_cell(tmp_path)
    out = session.run_cell(cell, SEED, 3.0, False, "cpu", control=True)
    assert out["correct"], out["checks"]
    r = out["readings"]
    limit = cell.limits["max_logit_gap"]["limit"]
    assert r["max_logit_gap"] <= limit < r["control_gap"]
    assert r["tokens"] >= 40


def _fault_token(mp):
    from repro_torch.serve import step
    orig = step._greedy
    mp.setattr(step, "_greedy", lambda lg: (orig(lg) + 1) % lg.shape[-1])


def _fault_state_unchanged(mp):
    from repro_torch.models import layers
    orig = layers.attention_decode_paged

    def stale(params, cfg, x, pos, kpool, vpool, table, **kw):
        out, _, _ = orig(params, cfg, x, pos, kpool.clone(), vpool.clone(),
                         table, **kw)
        return out, kpool, vpool
    mp.setattr(layers, "attention_decode_paged", stale)


def _fault_half_batch(mp):
    from repro_torch.models import transformer
    orig = transformer.decode_step_paged

    def half(*a, **kw):
        logits, cache = orig(*a, **kw)
        B = logits.shape[0]
        keep = logits[:B - B // 2]
        return torch.cat([keep, keep.mean(0, keepdim=True)
                          .expand(B // 2, *keep.shape[1:])]), cache
    mp.setattr(transformer, "decode_step_paged", half)


@pytest.mark.parametrize("fault", [_fault_token, _fault_state_unchanged,
                                   _fault_half_batch],
                         ids=["token_altered", "state_unchanged",
                              "half_batch_left_out"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    cell = tiny_cell(tmp_path)
    fault(monkeypatch)
    out = session.run_cell(cell, SEED, 3.0, False, "cpu")
    assert not out["correct"], out["checks"]
