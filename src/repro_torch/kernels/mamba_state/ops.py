"""Public wrapper for the Mamba2 decode state step over the paged layout's
per-slot state (`models/mamba2.py::mamba2_decode_paged`): each live row's
f32 state h' = exp(dt A) h + (dt x) B^T in place, and y = C h'.

For CUDA tensors this launches the hand-written Hopper kernel
(csrc/mamba_state.cu), one launch for every row and head: it reads and
writes each live row's state once and reduces y in the same pass, and does
not touch a dead row's state. It takes the widths the port's Mamba2 models
have (`takes`: an f32 state, d_state 128 with head dim <= 64, or 32 with
head dim <= 256) and raises ValueError on any other; a build or launch
failure raises too. Nothing on a CUDA tensor is answered with the plain
PyTorch version (ref.py): that runs on CPU tensors alone.

There is no backward (`kernels.refuse_grad`): with grad enabled and an
input that requires one, the wrapper raises on every device.

`mamba_state.launches` counts the calls that launched the kernel (CUDA
tensors only), so a run can show that its decode went through it: one per
Mamba2 layer per decode step. It counts through `kernels.count_launch`: a
call made while a CUDA graph is captured counts when the graph is replayed
(`serve.graph`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import count_launch, refuse_grad
from repro_torch.kernels.mamba_state.ref import mamba_state_ref

DTYPES = (torch.float32, torch.bfloat16)    # of x, B and C
# d_state -> the most head dim: one block of the kernel covers a head's rows
# (granite-4.0-h-small and mamba2-130m: 128 and 64; their reduced configs:
# 32 and 32)
WIDTHS = {128: 64, 32: 256}


def takes(p: int, n: int, dtype) -> bool:
    """Whether the kernel takes a state of head dim p, d_state n and dtype
    `dtype`: f32 (the state's type in every Mamba2 model of the port), and
    one of the widths in WIDTHS."""
    return dtype == torch.float32 and 1 <= p <= WIDTHS.get(n, 0)


def _check_cuda_args(ssm, x, dt, A, B, C, live):
    """Raise ValueError on anything the CUDA kernel does not take."""
    if ssm.dim() != 4 or not takes(ssm.shape[2], ssm.shape[3], ssm.dtype):
        raise ValueError(
            f"mamba_state: the kernel takes an f32 state (b, h, p, n) of a "
            f"d_state n and at most p rows in {{n: p}} {WIDTHS}; got "
            f"{ssm.dtype} {tuple(ssm.shape)}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C),
                    ("live", live)):
        if t.device != ssm.device:
            raise ValueError(f"{name} is on {t.device}, ssm on {ssm.device}")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x/B/C dtypes {x.dtype}/{B.dtype}/{C.dtype} must "
                         f"be equal and in {DTYPES}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype} and "
                         f"{A.dtype}")
    if live.dtype != torch.bool:
        raise ValueError(f"live must be bool, got {live.dtype}")
    if x.dim() != 3 or B.dim() != 3 or ssm.dim() != 4:
        raise ValueError("expected ssm (b,h,p,n), x (b,h,p), B and C "
                         "(b,g,n)")
    b, h, p = x.shape
    g, n = B.shape[1], B.shape[2]
    if tuple(ssm.shape) != (b, h, p, n) or tuple(dt.shape) != (b, h) \
            or tuple(A.shape) != (h,) or B.shape != C.shape \
            or B.shape[0] != b or tuple(live.shape) != (b,):
        raise ValueError(f"shapes do not match: ssm {tuple(ssm.shape)}, x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, live {tuple(live.shape)}")
    if g < 1 or h % g:
        raise ValueError(f"heads {h} not a multiple of groups {g}")
    if not ssm.is_contiguous() or ssm.data_ptr() % 16:
        raise ValueError("ssm must be contiguous and 16-byte aligned")
    for name, t in (("dt", dt), ("A", A), ("live", live)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def mamba_state(ssm, x, dt, A, B, C, live):
    """ssm: (b, h, p, n) f32, stepped in place where `live` (b,) bool
    holds, the other rows' state left as it is; x: (b, h, p); dt: (b, h)
    f32 (after softplus); A: (h,) f32; B, C: (b, g, n). Returns y (b, h, p)
    f32; a dead row's y is garbage its caller ignores (zeros from the
    kernel). Forward only, on every device (`refuse_grad`)."""
    refuse_grad("mamba_state", ssm, x, dt, A, B, C)
    if ssm.device.type == "cpu":
        return mamba_state_ref(ssm, x, dt, A, B, C, live)
    if ssm.device.type != "cuda":
        raise ValueError(f"mamba_state takes CUDA or CPU tensors, got "
                         f"{ssm.device}")
    _check_cuda_args(ssm, x, dt, A, B, C, live)
    from repro_torch.kernels.mamba_state.kernel import mamba_state_kernel
    y = mamba_state_kernel(ssm, x, dt, A, B, C, live)
    count_launch(mamba_state)
    return y


mamba_state.launches = 0
