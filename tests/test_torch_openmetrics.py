"""The port's copy of tests/test_openmetrics.py, case for case:
repro_torch's tiny-config engines on the CPU (seeded torch weights,
`device="cpu"`). The reference's docstring follows.

OpenMetrics exposition contract (S3): the strict in-repo parser holds
the exporter to the text-format spec — TYPE/HELP per family, metric-name
sanitization, label escaping, ``_total``-suffixed counters, ``# EOF`` —
and counter monotonicity is proven across consecutive scrapes of the
live stdlib-HTTP endpoint."""
import json
import urllib.error
import urllib.request

import pytest
import torch

from _torch_host import one_torch_thread, shut_down_gateways  # noqa: F401
from repro_torch.configs.base import ModelConfig
from repro_torch.gateway.gateway import Gateway
from repro_torch.models import transformer as T
from repro_torch.obs.export import (MetricsServer, OpenMetricsParseError,
                                    escape_label_value, openmetrics_text,
                                    parse_openmetrics, sanitize_name)
from repro_torch.obs.ledger import UtilizationLedger

V = 41
PROMPTS = [[3, 1, 4, 1], [5, 9, 2], [6, 5, 3, 5], [8, 9, 7]]


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig("t", "dense", 2, 32, 2, 2, 64, V)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    return params, cfg


# ------------------------------------------------------------- rendering

class TestRender:
    def test_counter_vs_gauge_typing(self):
        snap = {"gateway": {"completed": 3, "queue_depth": 2}}
        text = openmetrics_text(snap)
        fams = parse_openmetrics(text)
        c = fams["repro_gateway_completed"]
        assert c["type"] == "counter"
        assert c["samples"] == {"repro_gateway_completed_total": 3.0}
        g = fams["repro_gateway_queue_depth"]
        assert g["type"] == "gauge"
        assert g["samples"] == {"repro_gateway_queue_depth": 2.0}

    def test_every_family_has_type_and_help(self):
        snap = {"a": {"completed": 1, "depth": 0.5, "on": True}}
        fams = parse_openmetrics(openmetrics_text(snap))
        assert fams
        for name, fam in fams.items():
            assert fam["type"] in ("counter", "gauge"), name
            assert fam["help"], name

    def test_name_sanitization(self):
        assert sanitize_name("a.b-c d") == "a_b_c_d"
        assert sanitize_name("0led").startswith("_")
        snap = {"weird scope!": {"p99.9": 1.0}}
        fams = parse_openmetrics(openmetrics_text(snap))
        assert "repro_weird_scope__p99_9" in fams

    def test_colliding_names_disambiguated(self):
        # "a.b_c" and "a.b.c" sanitize onto one family name; the exporter
        # must not emit a duplicate family the strict parser rejects
        snap = {"a": {"b_c": 1.0, "b": {"c": 2.0}}}
        fams = parse_openmetrics(openmetrics_text(snap))
        assert "repro_a_b_c" in fams and "repro_a_b_c_2" in fams

    def test_non_numeric_leaves_skipped(self):
        snap = {"flight": {"last_dump": "flightrec/f.json", "dumps": 0}}
        text = openmetrics_text(snap)
        assert "last_dump" not in text
        assert "repro_flight_dumps_total 0" in text

    def test_label_escaping_roundtrip(self):
        assert escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'
        led = UtilizationLedger()
        nasty = 'acme "prod"\\eu\nnorth'
        led.tag("r1", nasty, 1)
        led.record_step("decode", 0.25, [("r1", 4, 2)], pool_blocks=3)
        text = openmetrics_text({}, ledger=led)
        fams = parse_openmetrics(text)       # strict: bad escapes raise
        samples = fams["repro_ledger_tenant_device_seconds"]["samples"]
        (key, val), = samples.items()
        assert val == 0.25
        assert '\\"prod\\"' in key and "\\\\eu" in key and "\\n" in key
        assert "\n" not in key               # raw newline never escapes out

    def test_ledger_families_labeled_per_tenant(self):
        led = UtilizationLedger()
        led.tag("a", "t0", 0)
        led.tag("b", "t1", 1)
        led.record_step("decode", 1.0, [("a", 3, 1), ("b", 1, 2)])
        fams = parse_openmetrics(openmetrics_text({}, ledger=led))
        dev = fams["repro_ledger_tenant_device_seconds"]["samples"]
        assert dev[
            'repro_ledger_tenant_device_seconds_total'
            '{tenant="t0",tier="0"}'] == 0.75
        tok = fams["repro_ledger_tenant_tokens"]["samples"]
        assert sum(tok.values()) == 4.0


# ---------------------------------------------------------------- parser

class TestStrictParser:
    def test_missing_eof(self):
        with pytest.raises(OpenMetricsParseError, match="EOF"):
            parse_openmetrics("# TYPE a gauge\n# HELP a h\na 1")

    def test_content_after_eof(self):
        with pytest.raises(OpenMetricsParseError, match="after # EOF"):
            parse_openmetrics("# EOF\na 1")

    def test_sample_without_family(self):
        with pytest.raises(OpenMetricsParseError, match="no TYPE/HELP"):
            parse_openmetrics("orphan 1\n# EOF")

    def test_counter_requires_total_suffix(self):
        text = "# HELP a h\n# TYPE a counter\na 1\n# EOF"
        with pytest.raises(OpenMetricsParseError, match="_total"):
            parse_openmetrics(text)

    def test_metadata_after_samples(self):
        text = "# HELP a h\n# TYPE a gauge\na 1\n# TYPE a gauge\n# EOF"
        with pytest.raises(OpenMetricsParseError, match="after its samples"):
            parse_openmetrics(text)

    def test_duplicate_type(self):
        text = "# TYPE a gauge\n# TYPE a gauge\na 1\n# EOF"
        with pytest.raises(OpenMetricsParseError, match="duplicate TYPE"):
            parse_openmetrics(text)

    def test_duplicate_sample(self):
        text = "# TYPE a gauge\na 1\na 2\n# EOF"
        with pytest.raises(OpenMetricsParseError, match="duplicate sample"):
            parse_openmetrics(text)

    def test_bad_label_escape(self):
        text = '# TYPE a gauge\na{l="bad\\q"} 1\n# EOF'
        with pytest.raises(OpenMetricsParseError, match="illegal escape"):
            parse_openmetrics(text)

    def test_bad_label_name(self):
        text = '# TYPE a gauge\na{9l="x"} 1\n# EOF'
        with pytest.raises(OpenMetricsParseError, match="label"):
            parse_openmetrics(text)

    def test_non_float_value(self):
        text = "# TYPE a gauge\na one\n# EOF"
        with pytest.raises(OpenMetricsParseError, match="non-float"):
            parse_openmetrics(text)

    def test_blank_line_rejected(self):
        with pytest.raises(OpenMetricsParseError, match="blank"):
            parse_openmetrics("\n# EOF")

    def test_bad_metric_name(self):
        with pytest.raises(OpenMetricsParseError):
            parse_openmetrics("# TYPE 9bad gauge\n9bad 1\n# EOF")


# ------------------------------------------------------------ live server

def _scrape(port: int, path: str = "/metrics") -> str:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return resp.read().decode()


def test_endpoint_scrapes_parse_and_counters_are_monotonic(model):
    """S3 acceptance: two consecutive scrapes of the live endpoint both
    parse strictly, every family carries TYPE and HELP, and no counter
    ever decreases between scrapes (``repro_obs_scrapes_total`` proves
    strict increase)."""
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=32,
                       kv_layout="paged", block_size=4)
    gw.arm_ledger()
    sampler = gw.start_sampler(interval_s=0.005)
    srv = MetricsServer(gw.snapshot, sampler=sampler, ledger=gw.ledger)
    port = srv.start()
    try:
        for i, p in enumerate(PROMPTS[:2]):
            gw.submit(p, max_new_tokens=3, tenant=f"t{i}", tier=i)
        first = parse_openmetrics(_scrape(port))
        gw.run()
        second = parse_openmetrics(_scrape(port))
        for fams in (first, second):
            for name, fam in fams.items():
                assert fam["type"] is not None, f"{name}: no TYPE"
                assert fam["help"] is not None, f"{name}: no HELP"
        # counter monotonicity across scrapes, family by family
        for name, fam in first.items():
            if fam["type"] != "counter" or name not in second:
                continue
            for key, v0 in fam["samples"].items():
                v1 = second[name]["samples"].get(key)
                if v1 is not None:
                    assert v1 >= v0, f"counter {key} decreased: {v0} -> {v1}"
        s0 = first["repro_obs_scrapes"]["samples"]["repro_obs_scrapes_total"]
        s1 = second["repro_obs_scrapes"]["samples"]["repro_obs_scrapes_total"]
        assert s1 > s0
        # work happened between the scrapes and the counters saw it
        done = second["repro_gateway_completed"]["samples"]
        assert done["repro_gateway_completed_total"] == 2.0
        # labeled ledger families are live too
        assert any("ledger_tenant_device_seconds" in n for n in second)
    finally:
        srv.stop()
        gw.shutdown()


def test_endpoint_series_snapshot_and_404(model):
    params, cfg = model
    gw = Gateway.build(params, cfg, device="cpu",
                       replicas=1, batch_slots=2, cache_len=32)
    sampler = gw.start_sampler(interval_s=0.005)
    srv = MetricsServer(gw.snapshot, sampler=sampler)
    port = srv.start()
    try:
        gw.submit(PROMPTS[0], max_new_tokens=3)
        gw.run()
        sampler.sample_now()
        lines = _scrape(port, "/series.jsonl").splitlines()
        docs = [json.loads(ln) for ln in lines]
        assert any(d["name"] == "gateway.completed" for d in docs)
        snap = json.loads(_scrape(port, "/snapshot.json"))
        assert snap["gateway"]["completed"] == 1
        with pytest.raises(urllib.error.HTTPError) as err:
            _scrape(port, "/nope")
        assert err.value.code == 404
        parse_openmetrics(_scrape(port))       # /metrics is the default
        assert srv.stats()["scrapes"] >= 1
    finally:
        srv.stop()
        gw.shutdown()
    assert srv.stats()["listening"] is False


def test_server_restart_and_ephemeral_port():
    srv = MetricsServer(lambda: {"a": {"completed": 1}})
    p1 = srv.start()
    assert srv.start() == p1                   # idempotent while running
    parse_openmetrics(_scrape(p1))
    srv.stop()
    p2 = srv.start()                           # restartable after stop
    parse_openmetrics(_scrape(p2))
    srv.stop()
