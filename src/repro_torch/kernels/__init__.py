"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel package holds `ref.py` (the plain version, also what CPU
tensors run), `kernel.py` (the ctypes launcher of a `csrc/*.cu` source) and
`ops.py` (the checked public wrapper with its launch counter). `build`
compiles the CUDA sources with nvcc on first use.

`refuse_grad` is the one rule all the wrappers share: none has a backward.

Launch counting (`count_launch`) is shared by the wrappers whose kernels a
CUDA graph captures or whose callers run on several threads: a wrapper's
`.launches` counts its calls that launched its kernel. A call made while
the calling thread captures a CUDA graph launches nothing then: it counts
in that thread's own `captured_here()`, by wrapper, and whoever replays
the graph adds the captured calls per replay (`add_launches`,
`serve.graph`). Replicas of the gateway step their engines on threads of
their own, so `.launches` only grows under a lock, and a capture reads only
its own thread's calls, never another replica's.
"""
import threading

import torch

_COUNT_LOCK = threading.Lock()
_CAPTURED = threading.local()   # .calls: {wrapper: calls while capturing}


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


def count_launch(wrapper):
    """Count one call of `wrapper` (a function with a `.launches` count)
    that launched its kernel, or, while this thread captures a CUDA graph,
    one captured call in `captured_here()`."""
    if torch.cuda.is_current_stream_capturing():
        calls = _CAPTURED.__dict__.setdefault("calls", {})
        calls[wrapper] = calls.get(wrapper, 0) + 1
    else:
        add_launches({wrapper: 1})


def captured_here() -> dict:
    """The calls this thread made while capturing CUDA graphs, by wrapper
    (a copy)."""
    return dict(getattr(_CAPTURED, "calls", {}))


def captured_since(before: dict) -> dict:
    """This thread's captured calls since `before` (a `captured_here()`),
    by wrapper."""
    return {w: n - before.get(w, 0) for w, n in captured_here().items()
            if n != before.get(w, 0)}


def add_launches(counts: dict):
    """Add counts[wrapper] launches to each wrapper's `.launches` (a graph
    replay adds its captured calls); safe against other threads counting
    at once."""
    with _COUNT_LOCK:
        for wrapper, n in counts.items():
            wrapper.launches += n
