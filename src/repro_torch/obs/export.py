"""OpenMetrics/Prometheus text exposition over a zero-dependency endpoint.

`openmetrics_text` renders a `MetricsRegistry.snapshot()`-shaped dict as
the Prometheus text format (TYPE/HELP families, ``_total``-suffixed
counter samples, label escaping, ``# EOF`` terminator) so any standard
scraper can poll the serving stack without this repo growing a client
dependency. `MetricsServer` serves it from a stdlib
`ThreadingHTTPServer` — ``serve --metrics-port N`` — alongside the raw
JSONL time series (``/series.jsonl``) and the snapshot itself
(``/snapshot.json``).

`parse_openmetrics` is the strict in-repo parser the test suite uses to
hold the exposition to the format contract (family typing, name/label
escaping, counter monotonicity across scrapes); it is intentionally
unforgiving — a parse error here is an exposition bug, not bad input.

Counter-vs-gauge typing is by explicit key sets: snapshot scopes are
plain dicts with no instrument metadata attached, and guessing from the
name shape would silently mistype (``n_requests`` *falls* on requeue
re-entry; ``queue_depth`` goes both ways). Keys not known monotonic are
exported as gauges — the safe default, since a gauge-typed counter is
still scrapeable while a counter-typed gauge breaks rate() queries.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

# snapshot keys that are monotonic counts (exported as counter families;
# everything else is a gauge). Kept conservative: a key appears here only
# when its source only ever increments.
COUNTER_KEYS = frozenset({
    # gateway lifecycle + tokens
    "dispatched", "completed", "rejected", "failed", "retried",
    "illegal_transitions", "total_tokens", "requeues",
    # engine / speculation / scheduler
    "dispatches", "tokens_drafted", "tokens_accepted", "tokens_emitted",
    "tokens_rolled_back", "chunks_dispatched", "mixed_dispatches",
    "prefill_tokens_chunked", "prefill_tokens_total",
    "tokens_reused", "tokens_computed", "prefix_hits", "prefix_misses",
    "blocks_evicted", "blocks_released", "copies_on_write",
    # tracing / sampler / flight
    "spans_recorded", "spans_dropped", "samples", "sample_errors",
    "dumps", "suppressed", "events_recorded",
    # SLO
    "finished", "met", "breached", "submitted", "shed",
    # ledger
    "steps",
})
# prefixed counter families: shed_by_cause splits (shed_deadline, ...)
COUNTER_PREFIXES = ("shed_", "sheds_")

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def sanitize_name(raw: str) -> str:
    """Map an arbitrary dotted snapshot path onto the OpenMetrics name
    grammar ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (dots and any other illegal
    character become ``_``; a leading digit gets an ``_`` prefix)."""
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", raw)
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


def escape_label_value(v: str) -> str:
    """Backslash, double-quote, and newline escaping per the exposition
    format spec."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _is_counter(key: str) -> bool:
    leaf = key.rsplit(".", 1)[-1]
    return leaf in COUNTER_KEYS or leaf.startswith(COUNTER_PREFIXES)


def openmetrics_text(snapshot: dict, *, prefix: str = "repro",
                     ledger=None, extra_counters: Dict[str, int] = None) -> str:
    """Render a snapshot dict as OpenMetrics text.

    Scalar leaves become ``<prefix>_<scope>_<path>`` families. The
    utilization ledger (when armed) additionally exports *labeled*
    per-tenant/per-tier families — the one place flat scope dicts can't
    express the data. Non-numeric leaves are skipped (strings carry no
    sample value); bools export as 0/1 gauges.
    """
    from repro_torch.obs.timeseries import flatten_numeric
    lines: List[str] = []
    seen: set = set()

    def family(name: str, typ: str, help_: str,
               samples: List[Tuple[str, float]]):
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {typ}")
        lines.extend(f"{s} {_fmt(v)}" for s, v in samples)

    def uniq(name: str) -> str:
        # two dotted keys can sanitize onto one family name ("a.b_c" vs
        # "a.b.c"); disambiguate deterministically rather than emit a
        # duplicate family the strict parser rejects
        if name not in seen:
            seen.add(name)
            return name
        i = 2
        while f"{name}_{i}" in seen:
            i += 1
        seen.add(f"{name}_{i}")
        return f"{name}_{i}"

    flat = flatten_numeric(snapshot)
    for key in sorted(flat):
        v = flat[key]
        name = uniq(sanitize_name(f"{prefix}_{key}"))
        if _is_counter(key):
            family(name, "counter", f"snapshot field {key} (monotonic)",
                   [(name + "_total", v)])
        else:
            family(name, "gauge", f"snapshot field {key}", [(name, v)])

    if extra_counters:
        for key in sorted(extra_counters):
            name = uniq(sanitize_name(f"{prefix}_{key}"))
            family(name, "counter", f"{key} (monotonic)",
                   [(name + "_total", float(extra_counters[key]))])

    if ledger is not None:
        rep = ledger.report()
        tname = uniq(f"{prefix}_ledger_tenant_device_seconds")
        bname = uniq(f"{prefix}_ledger_tenant_block_seconds")
        kname = uniq(f"{prefix}_ledger_tenant_tokens")
        tsamp, bsamp, ksamp = [], [], []
        for tenant, row in sorted(rep["tenants"].items()):
            lbl = (f'tenant="{escape_label_value(tenant)}",'
                   f'tier="{escape_label_value(str(row["tier"]))}"')
            tsamp.append((f"{tname}_total{{{lbl}}}", row["device_s"]))
            bsamp.append((f"{bname}_total{{{lbl}}}", row["block_s"]))
            ksamp.append((f"{kname}_total{{{lbl}}}", float(row["tokens"])))
        if tsamp:
            family(tname, "counter",
                   "attributed device-seconds by tenant", tsamp)
            family(bname, "counter",
                   "integrated KV block-seconds held by tenant", bsamp)
            family(kname, "counter", "tokens attributed to tenant", ksamp)

    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v))


# --------------------------------------------------------------- parser

class OpenMetricsParseError(ValueError):
    pass


def parse_openmetrics(text: str) -> Dict[str, dict]:
    """Strict parse of exposition text into
    ``{family: {"type": ..., "help": ..., "samples": {sample_key: value}}}``
    where sample_key is ``name`` or ``name{labels}`` verbatim.

    Raises `OpenMetricsParseError` on any deviation from the contract the
    exporter promises: unknown line shapes, bad metric/label names, TYPE
    after samples, counter samples missing the ``_total`` suffix, missing
    ``# EOF``, or non-float values.
    """
    families: Dict[str, dict] = {}
    saw_eof = False
    for ln, line in enumerate(text.splitlines(), 1):
        if saw_eof:
            raise OpenMetricsParseError(f"line {ln}: content after # EOF")
        if not line:
            raise OpenMetricsParseError(f"line {ln}: blank line")
        if line == "# EOF":
            saw_eof = True
            continue
        if line.startswith("# "):
            parts = line.split(" ", 3)
            if len(parts) < 4 or parts[1] not in ("HELP", "TYPE"):
                raise OpenMetricsParseError(f"line {ln}: bad comment {line!r}")
            _, kind, fam, rest = parts
            if not _NAME_OK.match(fam):
                raise OpenMetricsParseError(
                    f"line {ln}: illegal family name {fam!r}")
            entry = families.setdefault(
                fam, {"type": None, "help": None, "samples": {}})
            if entry["samples"]:
                raise OpenMetricsParseError(
                    f"line {ln}: {kind} {fam} after its samples")
            if kind == "TYPE":
                if rest not in ("counter", "gauge", "histogram", "summary",
                                "untyped"):
                    raise OpenMetricsParseError(
                        f"line {ln}: bad TYPE {rest!r}")
                if entry["type"] is not None:
                    raise OpenMetricsParseError(
                        f"line {ln}: duplicate TYPE for {fam}")
                entry["type"] = rest
            else:
                entry["help"] = rest
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$", line)
        if not m:
            raise OpenMetricsParseError(f"line {ln}: bad sample {line!r}")
        name, labels, val = m.group(1), m.group(2) or "", m.group(3)
        if labels:
            _validate_labels(labels, ln)
        fam = _family_of(name, families)
        if fam is None:
            raise OpenMetricsParseError(
                f"line {ln}: sample {name!r} has no TYPE/HELP family")
        entry = families[fam]
        if entry["type"] == "counter" and not name.startswith(fam + "_total"):
            raise OpenMetricsParseError(
                f"line {ln}: counter sample {name!r} lacks _total suffix")
        try:
            fval = float(val)
        except ValueError:
            raise OpenMetricsParseError(
                f"line {ln}: non-float value {val!r}") from None
        key = name + labels
        if key in entry["samples"]:
            raise OpenMetricsParseError(f"line {ln}: duplicate sample {key!r}")
        entry["samples"][key] = fval
    if not saw_eof:
        raise OpenMetricsParseError("missing # EOF terminator")
    return families


def _family_of(sample_name: str, families: Dict[str, dict]) -> Optional[str]:
    # counter samples carry a _total suffix; match longest declared family
    for cand in (sample_name, sample_name.rsplit("_total", 1)[0]):
        if cand in families:
            return cand
    return None


def _validate_labels(labels: str, ln: int):
    body = labels[1:-1]
    # split on commas outside quotes
    pat = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(,|$)')
    pos = 0
    while pos < len(body):
        m = pat.match(body, pos)
        if not m:
            raise OpenMetricsParseError(
                f"line {ln}: bad label syntax in {labels!r}")
        raw = m.group(2)
        # consume escape pairs left-to-right: every backslash must start
        # a legal \\ \" \n pair, and no raw newline survives unescaped
        if not re.fullmatch(r'(?:[^\\\n]|\\[\\"n])*', raw):
            raise OpenMetricsParseError(
                f"line {ln}: illegal escape in label value {raw!r}")
        pos = m.end()


# ---------------------------------------------------------------- server

class MetricsServer:
    """Stdlib-HTTP exposition endpoint (no new dependencies).

    Routes: ``/metrics`` (OpenMetrics text), ``/series.jsonl`` (sampler
    rings), ``/snapshot.json`` (raw snapshot). ``port=0`` binds an
    ephemeral port; `start()` returns the actual one. The server owns one
    counter of its own — ``obs.scrapes`` — which the monotonicity test
    rides across consecutive scrapes.
    """

    def __init__(self, source: Callable[[], dict], *, port: int = 0,
                 host: str = "127.0.0.1", sampler=None, ledger=None,
                 prefix: str = "repro"):
        self.source = source
        self.sampler = sampler
        self.ledger = ledger
        self.prefix = prefix
        self.host = host
        self._port = port
        self.scrapes = 0
        self._mu = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def render_metrics(self) -> str:
        with self._mu:
            self.scrapes += 1
            n = self.scrapes
        return openmetrics_text(self.source(), prefix=self.prefix,
                                ledger=self.ledger,
                                extra_counters={"obs.scrapes": n})

    def start(self) -> int:
        if self._httpd is not None:
            return self.port
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib API name
                try:
                    if self.path.split("?")[0] == "/metrics":
                        body = server.render_metrics().encode()
                        ctype = ("application/openmetrics-text; "
                                 "version=1.0.0; charset=utf-8")
                    elif self.path == "/series.jsonl" and server.sampler:
                        body = server.sampler.to_jsonl().encode()
                        ctype = "application/jsonl; charset=utf-8"
                    elif self.path == "/snapshot.json":
                        body = json.dumps(server.source(),
                                          default=str).encode()
                        ctype = "application/json; charset=utf-8"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # noqa: BLE001 — 500, never a hang
                    self.send_error(500, explain=f"{type(e).__name__}: {e}")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # quiet: telemetry must not spam
                pass

        self._httpd = ThreadingHTTPServer((self.host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="metrics-http")
        self._thread.start()
        return self.port

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def stats(self) -> dict:
        with self._mu:
            return {"listening": self._httpd is not None,
                    "port": self.port, "scrapes": self.scrapes}
