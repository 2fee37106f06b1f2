"""The port stands alone: no module of `repro_torch`, not the root
`chip_smoke.py` and not the tools `tools/*.py` (the card probes, the
dry-run table) imports JAX or
the reference package `repro` — not at import time (a fresh interpreter
imports every module and inspects `sys.modules`) and not lazily inside a
function (every import statement in the sources is read)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "tools").glob("*.py")))

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_importing_every_module_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_import_statement_reaches_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


_ALONE = r"""
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_dryrun_alone_loads_no_jax_and_no_reference():
    """The dry-run's entry point imported first and alone in a fresh
    interpreter (it pulls in the rest of the distribution slice)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _ALONE,
                           "repro_torch.launch.dryrun"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
