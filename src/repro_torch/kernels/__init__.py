"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel package holds `ref.py` (the plain version, also what CPU
tensors run), `kernel.py` (the ctypes launcher of a `csrc/*.cu` source) and
`ops.py` (the checked public wrapper with its launch counter). `build`
compiles the CUDA sources with nvcc on first use.

`refuse_grad` is the one rule all four wrappers share: none has a backward.
"""
import torch


def refuse_grad(name: str, *tensors):
    """Raise NotImplementedError if autograd would have to differentiate
    through kernel `name`: grad mode is on and a tensor input requires a
    gradient. The reference cannot differentiate through its Pallas kernels
    either (`pallas_call` has no JVP rule there and no custom_vjp wraps
    them), and the kernels write fresh outputs with no graph behind them, so
    a backward would drop the inputs' gradients silently. Reads host
    attributes only, so it is safe while a CUDA graph is captured."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward, as the reference's Pallas kernel has "
            "none (jax cannot differentiate through its pallas_call); train "
            "with attention_impl='xla', or call it under torch.no_grad()")
