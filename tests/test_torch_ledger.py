"""The port's copy of tests/test_ledger.py, case for case:
repro_torch's tiny-config engines on the CPU (seeded torch weights,
`device="cpu"`). The reference's docstring follows.

Per-tenant utilization ledger: exact conservation of measured device
time, token-share splitting, pseudo-tenant handling, KV block-second
integration, agreement with the engine's step-latency histograms, and —
the PR's acceptance bar — token parity on every decode path with the
whole telemetry pipeline (sampler + endpoint + ledger) armed."""
import pytest
import torch

from _torch_host import one_torch_thread, shut_down_gateways  # noqa: F401
from repro_torch.configs.base import ModelConfig
from repro_torch.gateway.gateway import Gateway
from repro_torch.models import transformer as T
from repro_torch.obs.export import MetricsServer
from repro_torch.obs.ledger import IDLE, UNTAGGED, UtilizationLedger
from repro_torch.serve.engine import ServeEngine

from test_torch_obs import PATHS

V = 41
PROMPTS = [[3, 1, 4, 3, 1, 4, 3, 1], [3, 1, 4, 3, 7], [9, 10, 11, 12],
           [5, 5, 5, 5, 5, 5]]


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig("t", "dense", 2, 32, 2, 2, 64, V)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    return params, cfg


# ------------------------------------------------------------------ unit

class TestLedgerUnit:
    def test_token_share_split(self):
        led = UtilizationLedger()
        led.tag("a", "acme", 0)
        led.tag("b", "bob", 1)
        led.record_step("decode", 1.0, [("a", 3, 0), ("b", 1, 0)])
        rep = led.report()
        assert rep["tenants"]["acme"]["device_s"] == pytest.approx(0.75)
        assert rep["tenants"]["bob"]["device_s"] == pytest.approx(0.25)
        assert rep["tenants"]["acme"]["tier"] == 0
        assert rep["by_kind"] == {"decode": 1.0}

    def test_conservation_is_exact_not_approximate(self):
        """Remainder-to-last: the sum of attributed seconds equals the
        sum of recorded seconds to the ulp, over many awkward splits."""
        led = UtilizationLedger()
        total = 0.0
        for i in range(200):
            secs = 0.001 * (i % 7 + 1) / 3.0        # non-representable
            shares = [(f"r{j}", (i + j) % 5, j) for j in range(1 + i % 4)]
            led.record_step("decode", secs, shares)
            total += secs
        rep = led.report()
        assert rep["attributed_device_s"] == pytest.approx(
            rep["total_device_s"], abs=1e-12)
        assert rep["conservation_err_frac"] == pytest.approx(0.0, abs=1e-12)
        assert rep["total_device_s"] == pytest.approx(total)

    def test_zero_token_step_splits_equally(self):
        led = UtilizationLedger()
        led.record_step("prefill", 0.4, [("a", 0, 0), ("b", 0, 0)])
        rep = led.report()
        assert rep["tenants"][UNTAGGED]["device_s"] == pytest.approx(0.4)

    def test_idle_and_untagged_pseudo_tenants(self):
        led = UtilizationLedger()
        led.record_step("decode", 0.1, [])          # no shares: idle
        led.record_step("decode", 0.2, [("ghost", 1, 0)])
        rep = led.report()
        assert rep["tenants"][IDLE]["device_s"] == pytest.approx(0.1)
        assert rep["tenants"][UNTAGGED]["device_s"] == pytest.approx(0.2)
        # device time is never silently dropped
        assert rep["conservation_err_frac"] == pytest.approx(0.0, abs=1e-12)

    def test_block_seconds_integration(self):
        led = UtilizationLedger()
        led.tag("a", "acme", 0)
        led.record_step("decode", 2.0, [("a", 1, 3)], pool_blocks=10)
        led.record_step("decode", 1.0, [("a", 1, 5)], pool_blocks=8)
        rep = led.report()
        assert rep["tenants"]["acme"]["block_s"] == pytest.approx(11.0)
        assert rep["pool_block_s"] == pytest.approx(28.0)

    def test_tier_rollup_and_stats_gate(self):
        led = UtilizationLedger()
        assert led.stats() is None                  # idle: scope omitted
        led.tag("a", "t0", 1)
        led.tag("b", "t1", 1)
        led.record_step("decode", 1.0, [("a", 1, 0), ("b", 1, 0)])
        rep = led.stats()
        assert rep["tiers"]["1"]["device_s"] == pytest.approx(1.0)
        assert rep["tiers"]["1"]["tokens"] == 2


# ---------------------------------------------------------- engine hookup

def test_engine_attribution_agrees_with_step_histograms(model):
    """One clock read feeds both sinks: the ledger's total device seconds
    equals the step-latency histograms' total milliseconds exactly, and
    every live slot's work is attributed."""
    params, cfg = model
    eng = ServeEngine(params, cfg, device="cpu", batch_slots=2, cache_len=32,
                      kv_layout="paged", block_size=4)
    led = eng.ledger = UtilizationLedger()
    for i, p in enumerate(PROMPTS):
        r = eng.submit(p, max_new_tokens=4)
        led.tag(r.request_id, f"tenant{i % 2}", i % 2)
    eng.run()
    rep = led.report()
    hist_total_s = sum(h.total for h in eng.step_times.values()) / 1e3
    assert rep["total_device_s"] == pytest.approx(hist_total_s, rel=1e-9)
    assert rep["attributed_device_s"] == pytest.approx(
        rep["total_device_s"], abs=1e-12)
    assert set(rep["tenants"]) == {"tenant0", "tenant1"}
    # paged layout: decode steps held KV blocks, so block-seconds accrued
    assert all(row["block_s"] > 0 for row in rep["tenants"].values())
    assert rep["pool_block_s"] > 0
    # every decode dispatch contributes one token share per live slot
    # (prefill adds computed prompt tokens on top — fewer than the raw
    # prompt lengths here, since these prompts share reusable prefixes)
    decode_only = sum(4 - 1 for _ in PROMPTS)   # first token rides prefill
    assert sum(r_["tokens"] for r_ in rep["tenants"].values()) > decode_only


def test_gateway_arm_ledger_tags_and_scopes(model):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=2, batch_slots=2, cache_len=32)
    led = gw.arm_ledger()
    assert gw.arm_ledger() is led               # idempotent
    assert all(r.engine.ledger is led for r in gw.replicas)
    reqs = [gw.submit(p, max_new_tokens=3, tenant=f"t{i % 2}", tier=i % 2)
            for i, p in enumerate(PROMPTS)]
    gw.run()
    assert all(r.done for r in reqs)
    rep = gw.snapshot()["ledger"]
    named = {t for t in rep["tenants"] if not t.startswith("(")}
    assert named == {"t0", "t1"}                # placement tagged every gid
    assert UNTAGGED not in rep["tenants"]
    assert rep["conservation_err_frac"] < 1e-9


def test_survives_engine_reset(model):
    """Warm replica reset (failover path) must not detach the ledger."""
    params, cfg = model
    eng = ServeEngine(params, cfg, device="cpu", batch_slots=2, cache_len=32)
    led = eng.ledger = UtilizationLedger()
    eng.submit(PROMPTS[0], max_new_tokens=2)
    eng.run()
    eng.reset()
    assert eng.ledger is led
    eng.submit(PROMPTS[1], max_new_tokens=2)
    eng.run()
    assert led.report()["steps"] >= 2


# -------------------------------------------- armed-pipeline token parity

@pytest.mark.parametrize("path", sorted(PATHS))
def test_armed_pipeline_parity_across_decode_paths(model, path):
    """Acceptance bar: with the sampler, the exposition endpoint, and the
    ledger all armed, every decode path emits byte-identical tokens to
    the disarmed oracle — telemetry is a pure observer — and attribution
    conserves the measured step time within the 1% bench bar."""
    params, cfg = model
    kw = dict(PATHS[path])
    if kw.get("kv_layout") == "paged":
        kw["block_size"] = 4

    def drive(armed: bool):
        gw = Gateway.build(params, cfg, device="cpu",
                           replicas=2, batch_slots=2,
                           cache_len=32, **kw)
        srv = None
        if armed:
            gw.arm_ledger()
            sampler = gw.start_sampler(interval_s=0.005)
            srv = MetricsServer(gw.snapshot, sampler=sampler,
                                ledger=gw.ledger)
            srv.start()
        reqs = [gw.submit(p, max_new_tokens=3 + 2 * i,
                          tenant=f"t{i % 2}", tier=i % 2)
                for i, p in enumerate(PROMPTS)]
        gw.run()
        gw.shutdown()
        if srv is not None:
            srv.stop()
        for r in reqs:
            assert r.done, f"{path}: req{r.gid} not done armed={armed}"
        return [r.output for r in reqs], gw

    baseline, _ = drive(armed=False)
    armed_out, gw = drive(armed=True)
    assert armed_out == baseline, f"telemetry changed tokens on {path}"
    rep = gw.ledger.report()
    assert rep["steps"] > 0
    assert rep["conservation_err_frac"] < 0.01
    hist_total_s = sum(
        sum(h.total for h in r.engine.step_times.values())
        for r in gw.replicas) / 1e3
    assert rep["total_device_s"] == pytest.approx(hist_total_s, rel=1e-6)
    assert gw.sampler.samples > 0
