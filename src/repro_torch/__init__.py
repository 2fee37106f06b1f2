"""PyTorch/CUDA port of the JAX package (`src/repro/`).

The JAX package is the reference and stays as it is. This package imports
torch, numpy and the standard library, never jax and never `repro.*`: what
it needs from the reference it keeps as its own copy, under the same module
names so a reader can find each counterpart. Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``.

Ported so far: serving (`serve/`, `kvcache/`, `models/`, the four Hopper
kernels under `kernels/` and `csrc/`), the gateway and the serve launcher
(`gateway/`, `chaos/`, `concurrency/`, `obs/`, `launch/serve.py`),
training (`optim/`, `train/`, `checkpoint/`, `data/`, `launch/train.py`)
and the paper's layer-design sweep (`core/`: the search space, scheduler,
sessions, queue and workers, the executors, the population plane as
stacked members, reporting; `launch/sweep.py`). Not yet: the MoE,
encoder-decoder and modality-prefix families, and distribution
(ROADMAP.md Queue 1).
"""
