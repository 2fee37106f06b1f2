"""The port's serve launcher (`python -m repro_torch.launch.serve`), called
through `main(argv)` on the CPU with `--device cpu`: reduced qwen3-1.7b on
the paged layout with the reference's `--decode-kernel pallas`, the
synthetic workload, a span trace and a chaos plan. Each run must end with
its summary lines; without CUDA and without `--device cpu` the launcher
must stop before it builds anything."""
import json

import pytest
import torch

from _torch_host import one_torch_thread, shut_down_gateways  # noqa: F401
from repro_torch.launch import serve

BASE = ["--arch", "qwen3-1.7b", "--kv-layout", "paged", "--decode-kernel",
        "pallas", "--replicas", "2", "--slots", "2", "--max-new", "4",
        "--cache-len", "64", "--device", "cpu"]


def _run(capsys, *extra):
    serve.main(BASE + list(extra))
    return capsys.readouterr().out.splitlines()


def _line(lines, prefix):
    hits = [ln for ln in lines if ln.startswith(prefix)]
    assert hits, f"no line starting {prefix!r} in:\n" + "\n".join(lines)
    return hits[-1]


def _summary_lines(lines, n_requests):
    assert _line(lines, "[serve] ").startswith("[serve] ")
    assert _line(lines, f"[serve] {n_requests} requests, ")
    assert _line(lines, "[serve] ttft p50=")
    assert _line(lines, "[serve] kvcache hit_rate=")


def test_paged_fleet_on_the_kernel_route(capsys, shut_down_gateways):
    lines = _run(capsys, "--requests", "6")
    _summary_lines(lines, 6)
    assert _line(lines, "  req0 (replica 0): prompt=[0, 1, 2] -> [")
    gw, = shut_down_gateways
    # "pallas" is the reference's name for the port's hand-written kernel
    assert [r.engine.decode_kernel for r in gw.replicas] == ["cuda", "cuda"]
    assert all(r.engine.kv_layout == "paged" for r in gw.replicas)


@pytest.mark.parametrize("name,engine_kernel", [("reference", "reference"),
                                                ("cuda", "cuda")])
def test_decode_kernel_names(capsys, shut_down_gateways, name,
                             engine_kernel):
    args = [a if a != "pallas" else name for a in BASE]
    serve.main(args + ["--requests", "2"])
    _summary_lines(capsys.readouterr().out.splitlines(), 2)
    gw, = shut_down_gateways
    assert {r.engine.decode_kernel for r in gw.replicas} == {engine_kernel}


def test_synthetic_workload(capsys):
    lines = _run(capsys, "--workload", "synth", "--workload-duration", "0.5",
                 "--workload-rate", "8", "--seed", "3")
    n = int(_line(lines, "[serve] workload: ").split()[2])
    assert n > 0
    _summary_lines(lines, n)


def test_trace_export(capsys, tmp_path):
    out = tmp_path / "serve.trace.json"
    lines = _run(capsys, "--requests", "3", "--trace", str(out))
    _summary_lines(lines, 3)
    assert _line(lines, "[serve] trace: ").endswith(
        "(load in https://ui.perfetto.dev)")
    names = {e["name"] for e in json.loads(out.read_text())["traceEvents"]}
    assert {"gateway.submit", "engine.step"} <= names


@pytest.mark.parametrize("mode", [[], ["--async-workers"]],
                         ids=["sync", "async"])
def test_chaos_crash_and_reintegration(capsys, shut_down_gateways, mode):
    lines = _run(capsys, "--requests", "8", "--chaos", "crash@d2:r0",
                 "--probation", "0", "--retry-backoff", "0.005", *mode)
    _summary_lines(lines, 8)
    assert _line(lines, "[serve] chaos armed: 1 fault(s)")
    assert _line(lines, "[serve] chaos fired: ") == \
        "[serve] chaos fired: {'crash': 1}"
    gw, = shut_down_gateways
    r0 = gw.replicas[0]
    assert r0.failures == 1 and r0.reintegrations == 1 and r0.healthy


def test_no_cuda_stops_unless_the_cpu_is_asked_for(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in BASE if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="--device cpu"):
        serve.main(args)
    assert capsys.readouterr().out == ""
