"""The yardstick's peaks: NVIDIA's data sheet for one H100 SXM (dense, no
sparsity), 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3;
the bound arithmetic of `chip_smoke.py` (bytes / 3.35 TB/s), copied. The
operations and bytes a step needs are the model family's
(`families/<name>.py`)."""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

_ELT = {"bfloat16": 2, "float16": 2, "float32": 4}


def elt_bytes(m: dict) -> int:
    return _ELT[m.get("dtype", "float32")]
