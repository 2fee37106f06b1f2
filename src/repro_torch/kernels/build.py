"""Build the hand-written CUDA kernels and load them with ctypes.

Each `repro_torch/csrc/<name>.cu` compiles on its own into a shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so a changed source or header builds anew on
first use and an unchanged one is loaded as it is.
`build()` starts one nvcc per source that needs it, all at once, and waits
for all of them. Nothing here runs at import time: the CPU tests import
every module, and the CPU has no nvcc.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parents[1] / "build"          # <repo>/build, git-ignored
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")                       # registers, smem, spills

# libraries loaded by this process, by source name
_LOADED: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise BuildError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                     "the CUDA kernels build only on a machine with the CUDA "
                     "toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source (default: all of csrc/) whose library is
    missing, one nvcc each, all started together. Returns nvcc's output per
    source it compiled (ptxas's register and shared-memory report). Raises
    BuildError naming every source that failed."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n in todo:
        # write to a private name, then rename: a concurrent build of the
        # same source never sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [exe, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(n))
        else:
            os.unlink(tmp)
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{logs[n]}")
    if failed:
        raise BuildError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def on_device(device):
    """A context in which `device` is the current CUDA device, for a launch
    on PyTorch's current stream there: nothing to enter when it already is
    (the common case, and the cheap one on every launch)."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
