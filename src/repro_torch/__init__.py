"""PyTorch/CUDA port of the JAX serving stack (`src/repro/`).

The JAX package is the reference and stays as it is. This package imports
torch, numpy and the standard library, never jax and never `repro.*`: what
it needs from the reference it keeps as its own copy, under the same module
names so a reader can find each counterpart. Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``.
"""
