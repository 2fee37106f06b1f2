"""The fused decode dispatch as one CUDA graph.

The reference jits its fused step (`serve.step.build_decode_fused`): one
`lax.scan` of N paged decode steps, one dispatch. The port's body is the
same N steps as a loop of torch ops; run eagerly, every op of every layer
of every step is a host dispatch, and the decode path is bound by the host
(PERF.md section 5). `FusedDecodeGraph` captures the body once as a CUDA
graph and replays it: N tokens for one launch from the host. It adds no
behaviour of its own.

On CPU tensors the body runs eagerly (the tests' path). On CUDA tensors
the graph is the only path: a failed capture or replay raises, and nothing
falls back to the eager loop.

A graph replays fixed addresses. The inputs (tokens, pos, table, eos,
live, steps) are copied in place into static tensors before each replay;
the outputs (emitted, live, steps) are tensors of the graph's own memory,
overwritten by the next replay. The graph also holds the addresses of the
weights and of the KV pools it was captured against: after the pools are
reallocated (`ServeEngine.reset`), call `release()` and the next call
captures anew; a call with other pools raises.

Other threads: the gateway's async replica workers step their engines on
threads of their own, so one replica may capture while another launches,
allocates, copies to the host or captures its own graph. The warm-up and
the capture run on a stream of this graph's own, the capture in CUDA's
thread-local mode (only the capturing thread is barred from calls that are
unsafe during a capture), and it is begun and ended directly: the
`torch.cuda.graph` context would synchronize the device and empty the
allocator's cache on entry, neither of which is legal while another
thread's capture is under way.

Launch counting: the paged-attention wrapper counts a call made during a
capture in its thread's own `captured_here()`, not in `.launches` (nothing
runs then). Each replay adds the launches recorded in its capture to
`paged_attention.launches`, so that counter keeps counting the kernel's
real launches, whichever threads capture and replay. `captures`,
`replays` and `warmup_runs` count this object's captures, replays and
eager warm-up runs of the body.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import ops as pa_ops

# eager runs of the body on a side stream before the capture (cuBLAS
# handles and workspaces, the kernel's library load); with every slot
# dead, so they write only the null page
WARMUP_RUNS = 2


class FusedDecodeGraph:
    """fused(params, tokens, pos, cache, table, eos, live, steps) ->
    (emitted, live, steps, cache), the contract of the body it wraps
    (`serve.step.build_decode_fused`)."""

    def __init__(self, body):
        self.body = body
        self.captures = 0
        self.replays = 0
        self.warmup_runs = 0
        self.release()

    def release(self):
        """Drop the captured graph (and its memory); the next CUDA call
        captures anew."""
        self._graph = None
        self._static = None
        self._out = None
        self._bound = None
        self._launches = 0

    @staticmethod
    def _addresses(params, cache):
        return (params["embed"]["table"].data_ptr(),
                tuple(t.data_ptr() for pool in cache for t in pool.values()))

    def __call__(self, params, tokens, pos, cache, table, eos, live, steps):
        args = (tokens, pos, table, eos, live, steps)
        if tokens.device.type != "cuda":
            return self.body(params, tokens, pos, cache, table, eos, live,
                             steps)
        if self._graph is None:
            self._capture(params, cache, args)
        elif self._addresses(params, cache) != self._bound:
            raise RuntimeError("the fused decode graph was captured against "
                               "other weights or KV pools; release() it "
                               "after reallocating them")
        for dst, src in zip(self._static, args):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"fused graph input {tuple(src.shape)} "
                                 f"{src.dtype}, captured with "
                                 f"{tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)
        self._graph.replay()
        self.replays += 1
        pa_ops.add_launches(self._launches)
        return (*self._out, cache)

    def _capture(self, params, cache, args):
        dev = args[0].device
        static = [a.clone() for a in args]
        tokens, pos, table, eos, live, steps = static
        dead = torch.zeros_like(live)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self.body(params, tokens, pos, cache, table, eos, dead, steps)
                self.warmup_runs += 1
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = pa_ops.captured_here()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                emitted, lv, st, _ = self.body(params, tokens, pos, cache,
                                               table, eos, live, steps)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self._launches = pa_ops.captured_here() - before
        self.captures += 1
        self._graph, self._static = graph, static
        self._out = (emitted, lv, st)
        self._bound = self._addresses(params, cache)
