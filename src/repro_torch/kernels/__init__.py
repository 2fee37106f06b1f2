"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel package holds `ref.py` (the plain version, also what CPU
tensors run), `kernel.py` (the ctypes launcher of a `csrc/*.cu` source) and
`ops.py` (the checked public wrapper with its launch counter). `build`
compiles the CUDA sources with nvcc on first use.
"""
