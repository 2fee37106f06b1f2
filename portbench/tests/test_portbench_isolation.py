"""No module of the benchmark imports JAX or the JAX package `repro`
(whole top-level names: `repro_torch` is not `repro`), the reference
imports nothing of the program, and a run without a CUDA device prints
no result."""
import json
import os
import subprocess
import sys

import pytest

from _portbench_fixture import ROOT
from portbench import isolation

SOURCES = sorted((ROOT / "portbench").rglob("*.py"))


def test_names_are_compared_whole():
    assert not isolation.forbidden("repro_torch.serve.engine")
    assert not isolation.forbidden("jaxtyping")
    assert isolation.forbidden("repro") and isolation.forbidden("repro.x")
    assert isolation.forbidden("jax.numpy") and isolation.forbidden("flax")
    assert isolation.loaded(["repro_torch", "reprox", "jaxlib.xla"]) == \
        ["jaxlib.xla"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_import_statement_reaches_jax_or_the_jax_package(path):
    bad = [n for n in isolation.imports(path) if isolation.forbidden(n)]
    assert not bad, bad
    if "reference" in path.parts:
        own = [n for n in isolation.imports(path)
               if n.split(".")[0] in ("repro_torch", "portbench")
               and not n.startswith("portbench.reference")]
        assert not own, own


_PROBE = r"""
import importlib, pkgutil, sys
import portbench
from portbench import spec
names = [m.name for m in pkgutil.walk_packages(portbench.__path__,
                                               "portbench.")
         if ".tests" not in m.name and not m.name.endswith((".run", ".calibrate"))]
for n in names:
    importlib.import_module(n)
import repro_torch.gateway.gateway, repro_torch.kernels.build
for m in spec.load_benchmark()["per_layer"]:
    spec.metric_reader(m["name"])
from portbench import isolation
print(json.dumps({"n": len(names), "bad": isolation.loaded()}))
"""


def test_importing_the_harness_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", "import json\n" + _PROBE],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["n"] >= 10 and got["bad"] == []


def test_a_run_without_a_cuda_device_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "granite-moe-3b.longgen", "--seed", "1", "--seconds", "1",
         "--trace", "0"], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
