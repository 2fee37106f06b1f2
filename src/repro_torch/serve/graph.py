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

Launch counting: a kernel wrapper counts a call made during a capture in
its thread's own `kernels.captured_here()`, not in `.launches` (nothing
runs then). Each replay adds the calls recorded in its capture, by
wrapper, to their `.launches` (`kernels.add_launches`), so those counters
keep counting the kernels' real launches, whichever threads capture and
replay. `captures`,
`replays` and `warmup_runs` count this object's captures, replays and
eager warm-up runs of the body.

Device time by region: one warm-up serves two captures of the body, each
graph with a memory pool of its own. The plain graph replays while
tracing is off. The timed one records the body's `obs.trace` regions (the
first decode step's, `trace.cover`) as timing events inside the graph; it
replays inside a timed engine step (`trace.step_timer`), bracketed by two
events on the replaying stream, and hands the step its regions, which the
step reads after its host read. Event nodes cost device time in every
replay that runs them (0.55-0.67% of a replay's, PERF.md): the untraced
replays run none. The warm-up runs and both captures are one
`graph.capture` span and count as one capture.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

from repro_torch import kernels
from repro_torch.obs import trace as otrace

# eager runs of the body on a side stream before the capture (cuBLAS
# handles and workspaces, the kernel's library load); with every slot
# dead, so they write only the null page
WARMUP_RUNS = 2

_GC_MU = threading.Lock()
_GC_PAUSES = 0
_GC_WAS_ON = True


@contextlib.contextmanager
def _collector_paused():
    """Collect garbage now, and not again until every capture under way in
    the process has ended: a graph freed by the collector on a capturing
    thread (another engine's, left in a reference cycle) is an operation
    the capture forbids, and it ends the capture."""
    global _GC_PAUSES, _GC_WAS_ON
    gc.collect()
    with _GC_MU:
        if _GC_PAUSES == 0:
            _GC_WAS_ON = gc.isenabled()
            gc.disable()
        _GC_PAUSES += 1
    try:
        yield
    finally:
        with _GC_MU:
            _GC_PAUSES -= 1
            if _GC_PAUSES == 0 and _GC_WAS_ON:
                gc.enable()


class FusedDecodeGraph:
    """fused(params, tokens, pos, cache, table, eos, live, steps) ->
    (emitted, live, steps, cache), the contract of the body it wraps
    (`serve.step.build_decode_fused`)."""

    def __init__(self, body):
        self.body = body
        self.captures = 0
        self.replays = 0
        self.warmup_runs = 0
        self.trace_tid = 0      # the track of the capture's span
        self.release()

    def release(self):
        """Drop the captured graphs (and their memory); the next CUDA call
        captures anew."""
        self._graph = None
        self._timed = None
        self._static = None
        self._out = None
        self._timed_out = None
        self._bound = None
        self._launches = {}             # captured calls, by kernel wrapper
        self._regions = []

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
        timer = otrace.step_timer()
        if timer is None:
            self._graph.replay()
            out = self._out
        else:
            a = timer.mark()
            self._timed.replay()
            timer.replayed(self._regions, a, timer.mark())
            out = self._timed_out
        self.replays += 1
        kernels.add_launches(self._launches)
        return (*out, cache)

    def _capture(self, params, cache, args):
        with otrace.span("graph.capture", tid=self.trace_tid), \
                otrace.GraphCapture() as cap:
            self._warm_and_capture(params, cache, args, cap)
        self._regions = cap.regions

    def _warm_and_capture(self, params, cache, args, cap):
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

        def capture(timed: bool):
            graph = torch.cuda.CUDAGraph()
            before = kernels.captured_here()
            with torch.cuda.stream(side), _collector_paused(), \
                    (cap.recording() if timed else contextlib.nullcontext()):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    emitted, lv, st, _ = self.body(params, tokens, pos, cache,
                                                   table, eos, live, steps)
                finally:
                    graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(side)
            return graph, (emitted, lv, st), kernels.captured_since(before)

        self._graph, self._out, self._launches = capture(False)
        self._timed, self._timed_out, _ = capture(True)
        self.captures += 1
        self._static = static
        self._bound = self._addresses(params, cache)
