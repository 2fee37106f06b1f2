"""The port's sweep launcher (`python -m repro_torch.launch.sweep`) against
the reference's: the same `[sweep]` lines (the plan's `tasks -> blocks +
queued` line equal for the same arguments), the four artifacts written,
every task done, and `--device cuda` without a card stopping with a
message."""
import sys

import pytest
import torch

jax = pytest.importorskip("jax")

from repro.launch import sweep as jax_sweep  # noqa: E402
from repro_torch.launch import sweep  # noqa: E402
from _torch_host import one_torch_thread  # noqa: E402,F401

ARTIFACTS = ["fig5_time_vs_layers.txt", "f1_accuracy_vs_capacity.txt",
             "f3_activations.md", "summary.md"]


def _lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("[sweep]")]


@pytest.mark.parametrize("plane", ["auto", "population"])
def test_launcher_prints_the_reference_lines(plane, tmp_path, capsys,
                                             monkeypatch):
    args = ["--n-tasks", "24", "--epochs", "1", "--plane", plane]
    assert sweep.main(["--device", "cpu", *args,
                       "--out", str(tmp_path / "port")]) == 0
    port = _lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["sweep", *args,
                                      "--out", str(tmp_path / "ref")])
    jax_sweep.main()
    ref = _lines(capsys.readouterr().out)

    assert len(port) == len(ref) == 3 + len(ARTIFACTS)
    assert port[:2] == ref[:2]            # the dataset and the plan
    assert " 24/24 done (0 failed) in " in port[2]
    assert port[2].endswith(" tasks/s")
    if plane == "population":
        assert not port[1].endswith(" 0 population blocks + 24 queued")
    for name, line in zip(ARTIFACTS, port[3:]):
        assert line == f"[sweep] wrote {tmp_path / 'port'}/{name}"
        assert (tmp_path / "port" / name).read_text().strip()
    summary = (tmp_path / "port" / "summary.md").read_text()
    assert "| done | 24 |" in summary and "| failed | 0 |" in summary


def test_launcher_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        sweep.main(["--n-tasks", "2", "--out", str(tmp_path)])
    assert not (tmp_path / "summary.md").exists()
