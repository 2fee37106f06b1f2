"""Batched serving engine: fixed-slot continuous batching, the port of
`repro.serve.engine.ServeEngine`'s phased path on both KV layouts.

A `ServeEngine` owns a decode cache and `batch_slots` sequences. Requests
(prompt token lists) are admitted into free slots, prefilled, then all
active slots decode in lockstep, one token per `step()`. Finished
sequences (EOS or max_new_tokens) free their slot and waiting requests are
admitted. `kv_layout` picks the cache:

  * "dense" (the default, as in the reference): each slot owns a private
    (cache_len, ...) KV strip per attention layer, a ring when the model
    has a sliding window, and the state of each recurrent layer (RG-LRU or
    Mamba2). Every ported family runs here, the hybrid recurrentgemma and
    the attention-free Mamba2 included. Bulk prefill runs the whole prompt
    through `forward_prefill` (the flash-attention, RG-LRU scan and SSD
    scan kernels with `cfg.attention_impl == "pallas"`) and copies the
    caches into the slot; pure-attention prompts are right-padded to
    power-of-two buckets, prompts of models with a recurrent mixer run at
    their exact length (padding would advance the state). A step writes
    only the cache rows of the slots that ride it, so admitting a request
    never touches a live peer's cache.
  * "paged": KV in a pool of `block_size`-token pages; a request reuses
    the longest prompt prefix already in the pool through the radix index
    (copy-on-write for a partially matching page). Pure-attention decoders
    only, no sliding window.

The decode step returns last-position logits (or, when every live slot is
greedy, the argmax taken on the device): each request carries its own
`Sampler`, so slots in one batch can decode greedy, temperature, top-k/
top-p with independent seeded streams. Logits reach the host sampler as
float32 numpy (numpy has no bf16).

`decode_kernel` picks the paged layout's per-token attention read: "cuda"
(the paged default) is the hand-written kernel (`kernels/paged_attention`,
csrc/paged_attention.cu) on the card and its plain version for CPU
tensors; "reference" is the dense-gather oracle. The dense layout reads its
cache with plain torch and takes only "reference", as the reference does.
Everything runs on `device` ("cuda" unless the caller passes another); the
engine never moves work to the CPU on its own. On a CUDA device the engine
allocates its caches and runs every step on a CUDA stream of its own, so
engines stepped by threads of their own (the gateway's async replica
workers) never wait at a host sync for another engine's queued work; the
stream first waits for the caller's, which made the weights.

Three decode variants stack on the paged layout, as in the reference:

  * `fused_tokens=N` (N > 1): while every live slot is greedy, `step()`
    runs up to N decode steps in one dispatch
    (`serve.step.build_decode_fused`), EOS and budgets masked on the
    device and reconciled on the host afterwards. On the card the N steps
    are one CUDA graph replay (`serve.graph.FusedDecodeGraph`, the port's
    stand-in for the reference's jit), captured at the first fused
    dispatch and again after `reset()` (which reallocates the pools the
    graph writes). A batch with a sampled slot takes single steps.
  * `spec_tokens=K` (K >= 1): a drafter (`serve.draft`; "ngram" by
    default) proposes K tokens per slot, one batched verify forward
    (`serve.step.build_decode_spec`) keeps what the model itself would
    have produced plus a bonus token, and rejected drafts roll back at
    block granularity (`KVCacheManager.rollback`). Greedy only like the
    fused path, and it takes precedence over it.
  * `scheduler="chunked"` (chunk_budget=N): while a prompt is being
    prefilled, each step is one mixed dispatch
    (`serve.step.build_mixed_step`): the lockstep decode of every decoding
    slot plus up to N tokens of the prompt, so a long prompt no longer
    stalls every decoding slot for its whole prefill. The first token is
    deferred to the chunk that completes the prompt; pages are radix-
    committed at every chunk boundary.

One deliberate difference from the reference: a dense slot is cleared when
a request is admitted into it. The reference's decode-mode prefill leaves
the previous request's recurrent state (RG-LRU or SSM state and conv
window) in the slot, so a recurrent model's tokens depended on what the
slot served before (ROADMAP.md Queue 3); attention entries were already
hidden by their positions.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kvcache import KVCacheManager, PoolExhausted
from repro_torch.models import transformer as T
from repro_torch.obs import trace as otrace
from repro_torch.obs.registry import Histogram
from repro_torch.serve.draft import make_drafter
from repro_torch.serve.graph import FusedDecodeGraph
from repro_torch.serve.sampler import GREEDY, Sampler, SamplingParams
from repro_torch.serve.scheduler import SCHEDULERS, ChunkedScheduler
from repro_torch.serve.step import (build_decode, build_decode_fused,
                                    build_decode_paged, build_decode_spec,
                                    build_mixed_step, build_prefill_bucketed,
                                    build_prefill_paged, bucket_len,
                                    prefill_into_cache)

DECODE_KERNELS = ("reference", "cuda")
PREFILL_MODES = ("decode", "bulk")
# while tracing, one eager step in this many (prefills and single decode
# steps, host-bound) carries device time by region: its marks and their
# reading cost about 5% of a host-bound prefill (PERF.md). Every fused
# dispatch carries it.
EAGER_TIMING_EVERY = 4


@dataclass
class Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    sampling: SamplingParams = GREEDY
    output: List[int] = field(default_factory=list)
    done: bool = False
    error: Optional[BaseException] = field(default=None, repr=False)

    def __post_init__(self):
        self._sampler = Sampler(self.sampling)

    def next_token(self, logits) -> int:
        return self._sampler.sample(logits)


class ServeEngine:
    def __init__(self, params, cfg, *, batch_slots: int = 4,
                 cache_len: int = 256, window=None,
                 prefill_mode: str = "decode", kv_layout: str = "dense",
                 block_size: int = 16, pool_blocks: Optional[int] = None,
                 decode_kernel: Optional[str] = None, fused_tokens: int = 1,
                 spec_tokens: int = 0, drafter=None,
                 scheduler: str = "phased", chunk_budget: int = 32,
                 device="cuda"):
        """The reference's constructor, plus `device`. prefill_mode:
        "decode" feeds the (uncached) prompt one token at a time through
        the decode step; "bulk" runs it in one forward. kv_layout: "dense"
        (private per-slot strips; every ported family; ring caches for
        sliding windows) or "paged" (KV in a pool of `block_size`-token
        pages with radix prefix reuse; pure-attention decoder archs only;
        window must be None; pool_blocks sizes the pool, by default 2x the
        slots' worth of pages + the null block, so retired prefixes stay
        cached). decode_kernel is the paged read, "cuda" (the default
        there) or "reference"; the dense layout takes "reference" (its
        default) only, as the reference does. fused_tokens (> 1),
        spec_tokens (>= 1, with `drafter`: an instance or a "ngram[:n]" /
        "model:<arch_id>" spec) and scheduler="chunked" (with
        `chunk_budget`) are the paged layout's decode variants (see the
        module docstring)."""
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be dense|paged, got {kv_layout}")
        if decode_kernel is None:
            decode_kernel = "cuda" if kv_layout == "paged" else "reference"
        if decode_kernel not in DECODE_KERNELS:
            raise ValueError(f"decode_kernel must be one of "
                             f"{DECODE_KERNELS}, got {decode_kernel!r}")
        if prefill_mode not in PREFILL_MODES:
            raise ValueError(f"prefill_mode must be one of {PREFILL_MODES}, "
                             f"got {prefill_mode!r}")
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        if scheduler not in SCHEDULERS:
            raise ValueError(f"scheduler must be one of {SCHEDULERS}, "
                             f"got {scheduler!r}")
        if kv_layout != "paged":
            if decode_kernel != "reference":
                raise ValueError(f"decode_kernel={decode_kernel!r} targets "
                                 "the paged block pool; use kv_layout="
                                 "'paged'")
            if fused_tokens > 1:
                raise ValueError("fused multi-token decode scans the paged "
                                 "decode step; use kv_layout='paged'")
            if spec_tokens > 0:
                raise ValueError("speculative decode verifies over (and "
                                 "rolls back) paged KV; use kv_layout="
                                 "'paged'")
            if scheduler == "chunked":
                raise ValueError("chunked prefill scatters bounded chunks "
                                 "into paged block tables; use "
                                 "kv_layout='paged'")
        if kv_layout == "paged":
            if (window if window is not None else cfg.window) is not None:
                raise ValueError("paged KV cache does not support sliding-"
                                 "window (ring) caches; use kv_layout=dense")
            if cache_len % block_size:
                raise ValueError(f"cache_len {cache_len} must be a multiple "
                                 f"of block_size {block_size}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch sees no CUDA device; "
                               "pass device='cpu' to run on the CPU")
        pdev = params["embed"]["table"].device
        if pdev.type != self.device.type or (
                self.device.index is not None and pdev != self.device):
            raise ValueError(f"params are on {pdev}, engine device is "
                             f"{self.device}")
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self.params = params
        self.cfg = cfg
        self.slots = batch_slots
        self.cache_len = cache_len
        self.kv_layout = kv_layout
        self.decode_kernel = decode_kernel
        self.prefill_mode = prefill_mode
        self.fused_tokens = int(fused_tokens)
        self.spec_tokens = int(spec_tokens)
        # brownout lever (set_degraded): parks the spec and fused lanes and
        # caps chunked-prefill chunks without touching any shape
        self.degraded = False
        with self._on_stream():
            self.drafter = make_drafter(drafter, device=self.device) \
                if spec_tokens > 0 else None
        self._decode_fused: Optional[FusedDecodeGraph] = None
        self._decode_spec = None
        # speculative-decode telemetry
        self.spec_dispatches = 0
        self.spec_tokens_drafted = 0
        self.spec_tokens_accepted = 0
        self.spec_tokens_emitted = 0
        self.spec_tokens_rolled_back = 0
        self.block_size = block_size
        self.manager: Optional[KVCacheManager] = None
        # chunked-prefill scheduler (None on the phased path)
        self.scheduler: Optional[ChunkedScheduler] = None
        self._slot_blocks: List[List[int]] = [[] for _ in range(batch_slots)]
        # two decode variants: the greedy one argmaxes on the device and
        # moves one int per slot to the host; the logits one feeds host-
        # side per-request sampling
        if kv_layout == "paged":
            nb = cache_len // block_size
            if pool_blocks is None:
                pool_blocks = 2 * batch_slots * nb + 1
            with self._on_stream():
                self.cache = T.init_paged_cache(cfg, pool_blocks, block_size,
                                                self.device)
            self.manager = KVCacheManager(pool_blocks, block_size)
            # per-slot block tables; row of ids into the pool tensors.
            # Retired/empty slots are all-zero -> the reserved null block
            self.table = np.zeros((batch_slots, nb), np.int32)
            self._decode_tok = build_decode_paged(cfg, window=window,
                                                  kernel=decode_kernel)
            self._decode_lg = build_decode_paged(cfg, window=window,
                                                 return_logits=True,
                                                 kernel=decode_kernel)
            self._prefill_tok = build_prefill_paged(cfg, window=window)
            self._prefill_lg = build_prefill_paged(cfg, window=window,
                                                   return_logits=True)
            if self.fused_tokens > 1:
                self._decode_fused = FusedDecodeGraph(build_decode_fused(
                    cfg, self.fused_tokens, window=window,
                    kernel=decode_kernel))
            if self.spec_tokens > 0:
                self._decode_spec = build_decode_spec(cfg, self.spec_tokens,
                                                      window=window)
            if scheduler == "chunked":
                self.scheduler = ChunkedScheduler(chunk_budget)
                self._mixed_tok = build_mixed_step(cfg, window=window,
                                                   kernel=decode_kernel)
                self._mixed_lg = build_mixed_step(cfg, window=window,
                                                  kernel=decode_kernel,
                                                  return_logits=True)
        else:
            with self._on_stream():
                self.cache = T.init_cache(cfg, batch_slots, cache_len,
                                          self.device)
            self._decode_tok = build_decode(cfg, window=window)
            self._decode_lg = build_decode(cfg, window=window,
                                           return_logits=True)
            self._prefill_tok = build_prefill_bucketed(cfg, window=window)
            self._prefill_lg = build_prefill_bucketed(cfg, window=window,
                                                      return_logits=True)
        # pad bulk prompts only where padding cannot distort state:
        # recurrent mixers (rglru, ssm) advance over pad tokens
        self._bucket_prompts = T.paged_supported(cfg)
        self.pos = np.full((batch_slots,), -1, np.int64)   # last written pos
        self.budget = np.zeros((batch_slots,), np.int64)
        self.active: List[Optional[Request]] = [None] * batch_slots
        # prompt tokens actually run through the model (prefix hits
        # subtract from this)
        self.prefill_tokens_computed = 0
        self._pending: List[Request] = []
        self._finished: List[Request] = []
        # observability: spans land on this track (the gateway sets it to
        # the replica id), and every step's wall time feeds a fixed-bucket
        # histogram per step kind (prefill/decode)
        self.trace_tid = 0
        self.step_times: Dict[str, Histogram] = {}
        # utilization attribution sink (the gateway's UtilizationLedger or
        # None): when set, every step's wall time is split across the
        # slots that rode the dispatch by token share
        self.ledger = None
        # long-lived frontends (the gateway) keep their own handles; set
        # False so finished requests are not retained engine-side forever
        self.retain_finished = True
        self._next_id = 0
        # gateway event hooks: fn(req, ...) or None
        self.on_token: Optional[Callable[[Request, int], None]] = None
        self.on_finish: Optional[Callable[[Request], None]] = None

    # ------------------------------------------------------------- intake
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None) -> Request:
        req = Request(self._next_id, list(prompt), max_new_tokens, eos_id,
                      sampling or GREEDY)
        self._next_id += 1
        return self.enqueue(req)

    def enqueue(self, req: Request) -> Request:
        """Admit an externally-built Request (the gateway constructs its own
        so ids and samplers survive cross-replica retries)."""
        if self.kv_layout == "paged" and \
                len(req.prompt) + req.max_new_tokens > self.cache_len:
            raise ValueError(
                f"request needs {len(req.prompt) + req.max_new_tokens} "
                f"token positions, table holds {self.cache_len}")
        self._pending.append(req)
        return req

    def free_slots(self) -> int:
        return sum(1 for a in self.active if a is None) - len(self._pending)

    def active_count(self) -> int:
        return sum(1 for a in self.active if a is not None)

    def pending_count(self) -> int:
        return len(self._pending)

    def has_work(self) -> bool:
        return bool(self._pending) or self.active_count() > 0

    # --------------------------------------------------- capacity / cache
    def token_capacity(self) -> int:
        """Hard per-request ceiling (prompt + new tokens): the slot's
        span, and on the paged layout also the pool itself (a pool smaller
        than one table can never serve a request larger than its usable
        pages)."""
        if self.kv_layout == "paged":
            usable = (self.manager.pool.n_blocks - 1) * self.block_size
            return min(self.cache_len, usable)
        return self.cache_len

    def free_token_capacity(self) -> int:
        """Token positions this engine could commit to right now: free
        slots x per-slot capacity, bounded on the paged layout by free +
        idle-cached pool blocks (the gateway's admission-by-token-budget
        consults this)."""
        free = self.free_slots()
        if free <= 0:
            return 0
        cap = free * self.cache_len
        if self.kv_layout == "paged":
            cap = min(cap, self.manager.free_tokens())
        return cap

    def cached_prefix_tokens(self, prompt) -> int:
        """How many leading tokens of `prompt` are already prefilled here
        (radix probe; 0 on the dense layout). The gateway's prefix-affinity
        policy ranks replicas by this."""
        if self.manager is None:
            return 0
        return self.manager.match_len(prompt)

    @property
    def cache_metrics(self):
        """kvcache.CacheMetrics of the paged pool; None on the dense
        layout."""
        return self.manager.metrics if self.manager is not None else None

    # ---------------------------------------------------------- lifecycle
    def reset(self):
        """Warm rebuild for replica reintegration after a crash: device
        cache re-initialized (with a fresh radix index and empty block
        tables on the paged layout), every slot empty, the chunked
        scheduler re-created and the model drafter's streams dropped. The
        step closures are kept; the fused graph, which writes the old
        pools, is released and captured again at the next fused
        dispatch. Work still queued on the engine's stream (a step that
        raised midway) finishes before the old caches are dropped."""
        if self._stream is not None:
            self._stream.synchronize()
        if self.kv_layout == "paged":
            pool_blocks = self.manager.pool.n_blocks
            if self._decode_fused is not None:
                self._decode_fused.release()
            with self._on_stream():
                self.cache = T.init_paged_cache(self.cfg, pool_blocks,
                                                self.block_size, self.device)
            self.manager = KVCacheManager(pool_blocks, self.block_size)
            self.table = np.zeros_like(self.table)
        else:
            with self._on_stream():
                self.cache = T.init_cache(self.cfg, self.slots,
                                          self.cache_len, self.device)
        self._slot_blocks = [[] for _ in range(self.slots)]
        self.pos = np.full((self.slots,), -1, np.int64)
        self.budget = np.zeros((self.slots,), np.int64)
        self.active = [None] * self.slots
        self._pending = []
        self._finished = []
        self.prefill_tokens_computed = 0
        if self.scheduler is not None:
            fresh = ChunkedScheduler(self.scheduler.chunk_budget)
            fresh._cap = self.scheduler._cap     # keep brownout throttle
            self.scheduler = fresh
        if self.drafter is not None and hasattr(self.drafter, "_streams"):
            # the draft model's streams are keyed by context; stale ones
            # from the crashed run must not seed retries
            self.drafter._streams.clear()

    def set_degraded(self, on: bool, *, chunk_cap: int = 8):
        """Brownout level-2 lever: park the speculative and fused lanes
        (their long bursts hold the lockstep batch under pressure) and cap
        chunked-prefill chunks at `chunk_cap` tokens. Lanes are skipped,
        not rebuilt, and the cap shortens the real run inside the fixed-
        width chunk operand: no shape changes."""
        self.degraded = bool(on)
        if self.scheduler is not None:
            self.scheduler.throttle(chunk_cap if on else None)

    # ------------------------------------------------------------- internals
    def _on_stream(self):
        """The context that makes the engine's CUDA stream current (no-op
        on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    @property
    def trace_tid(self) -> int:
        return self._trace_tid

    @trace_tid.setter
    def trace_tid(self, tid: int):
        self._trace_tid = tid
        if self._decode_fused is not None:
            self._decode_fused.trace_tid = tid

    def _observe_step(self, kind: str, t0: float, shares=None):
        """Record one step's wall ms under its step kind and, when the
        utilization ledger is armed, attribute the same measured seconds
        across the slots that rode the dispatch (`shares` is a list of
        ``(request_id, tokens, blocks_held)``)."""
        dt = time.perf_counter() - t0
        h = self.step_times.get(kind)
        if h is None:
            h = self.step_times[kind] = Histogram()
        h.observe(dt * 1e3)
        if self.ledger is not None:
            pool_blocks = self.manager.occupancy() \
                if self.manager is not None else 0
            self.ledger.record_step(kind, dt, shares or [],
                                    pool_blocks=pool_blocks)

    def _blocks_held(self, slot: int) -> int:
        """KV blocks this slot pins (0 on the dense layout)."""
        return len(self._slot_blocks[slot])

    def step_summary(self) -> Optional[dict]:
        """Per-step-kind wall-time stats (None before the first step):
        {kind: {count, mean, p50, p95, max}} in milliseconds."""
        if not self.step_times:
            return None
        return {k: h.summary() for k, h in sorted(self.step_times.items())}

    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _admit(self):
        if not self._pending:
            return
        with otrace.span("engine.admit", tid=self.trace_tid,
                         pending=len(self._pending)):
            self._admit_pending()

    def _admit_pending(self):
        for slot in range(self.slots):
            if self.active[slot] is None and self._pending:
                adm = None
                if self.kv_layout == "paged":
                    req = self._pending[0]
                    try:
                        adm = self.manager.admit(
                            req.prompt, len(req.prompt) + req.max_new_tokens)
                    except PoolExhausted as err:
                        if self.active_count() == 0:
                            # nothing in flight will ever free blocks: the
                            # request cannot be served — fail it, not the
                            # replica
                            self._pending.pop(0)
                            req.error = err
                            req.done = True
                            if self.retain_finished:
                                self._finished.append(req)
                            if self.on_finish:
                                self.on_finish(req)
                            continue
                        break       # retry after a running request retires
                req = self._pending.pop(0)
                self.active[slot] = req
                if self.scheduler is not None:
                    self._begin_chunked_prefill(slot, req, adm)
                else:
                    self._prefill_slot(slot, req, adm)

    def _emit(self, req: Request, tok: int):
        req.output.append(tok)
        if self.on_token:
            self.on_token(req, tok)

    def _sample_safe(self, req: Request, logits_row):
        """Host-side sampling is request-scoped: bad SamplingParams or NaN
        logits must fail only this request, never the whole replica.
        Returns the token, or the exception after recording it on the
        request."""
        try:
            return req.next_token(logits_row)
        except Exception as err:  # noqa: BLE001
            req.error = err
            return err

    def _host_logits(self, row) -> np.ndarray:
        return row.float().cpu().numpy()

    def _prefill_slot(self, slot: int, req: Request, adm=None):
        """Fill this slot's cache from the prompt. `adm` is the paged
        layout's Admission (block chain + reused-prefix length) from the
        manager; None on the dense layout."""
        t0 = time.perf_counter()
        tok0 = self.prefill_tokens_computed
        with otrace.span("engine.step", tid=self.trace_tid, step="prefill",
                         slot=slot, prompt_len=len(req.prompt),
                         reused=(adm.n_reused if adm is not None else 0)) \
                as span:
            timer = otrace.device_timer(self.device, EAGER_TIMING_EVERY)
            if adm is not None:
                first = self._paged_prefill_slot(slot, req, adm)
            else:
                first = self._dense_prefill_slot(slot, req)
            timer.attach(span)
            self._finish_prefill(slot, req, first)
        # share basis: prompt tokens actually computed (min 1 — a full
        # prefix hit still occupied the dispatch)
        computed = max(1, self.prefill_tokens_computed - tok0)
        self._observe_step("prefill", t0,
                           [(req.request_id, computed,
                             self._blocks_held(slot))])

    def _finish_prefill(self, slot: int, req: Request, first):
        """Emit the request's first generated token (or fail it request-
        scoped on a sampling error), arm the decode budget, retire on EOS
        or an exhausted budget."""
        self.pos[slot] = len(req.prompt) - 1
        if isinstance(first, Exception):        # request-scoped sampling bug
            self.budget[slot] = 0
            self._retire(slot)
            return
        hit_eos = req.eos_id is not None and first == req.eos_id
        if not hit_eos:
            self._emit(req, first)
        self.budget[slot] = req.max_new_tokens - 1
        if hit_eos or self.budget[slot] <= 0:
            self._retire(slot)

    def _wire_slot_table(self, slot: int, adm):
        """Point the slot's block-table row at the Admission's chain and
        perform the device half of copy-on-write: a partially matching
        page is cloned so our writes can't clobber the cached original
        (`cow_done` drops the manager's pin only AFTER the device copy)."""
        self._slot_blocks[slot] = list(adm.blocks)
        self.table[slot, :] = 0
        self.table[slot, :len(adm.blocks)] = adm.blocks
        if adm.cow is not None:
            src, dst = adm.cow
            T.copy_pool_blocks(self.cache, [src], [dst])
            self.manager.cow_done(src)

    def _begin_chunked_prefill(self, slot: int, req: Request, adm):
        """Chunked-scheduler admission: wire the slot's block table from
        the Admission (as the phased paged path does, copy-on-write
        included) but run no forward: `_step_mixed` slices the uncached
        prompt into bounded chunks that ride along decode dispatches. The
        first generated token is deferred to the chunk that completes the
        prompt."""
        self._wire_slot_table(slot, adm)
        if not req.prompt:
            # degenerate empty prompt: nothing to chunk; argmax of a zero
            # logits row (token 0), matching the phased path
            first = 0 if req.sampling.is_greedy else self._sample_safe(
                req, np.zeros((self.cfg.vocab_size,), np.float32))
            self._finish_prefill(slot, req, first)
            return
        self.scheduler.admit(slot, adm.n_reused)

    def _write_slot(self, slot: int, one):
        """Copy a one-row dense cache (`T.init_cache(cfg, 1, ...)` layout)
        into row `slot` of the engine's cache, in place."""
        for dst, src in zip(self.cache, one):
            for key, t in dst.items():
                t[slot] = src[key][0].to(t.dtype)

    def _empty_row(self):
        return T.init_cache(self.cfg, 1, self.cache_len, self.device)

    def _dense_prefill_slot(self, slot: int, req: Request):
        """Clear the slot, then fill it from the prompt: one bulk forward
        whose caches are copied into the slot, or len(prompt) decode steps
        that write this slot's cache rows and no other. Returns the first
        generated token."""
        greedy = req.sampling.is_greedy
        P = len(req.prompt)
        self.prefill_tokens_computed += P
        if self.prefill_mode == "bulk" and req.prompt:
            Sb = bucket_len(P, self.cache_len) if self._bucket_prompts else P
            toks = self._ints([req.prompt + [0] * (Sb - P)])
            prefill = self._prefill_tok if greedy else self._prefill_lg
            out, nat = prefill(self.params, {"tokens": toks}, P)
            self._write_slot(slot, prefill_into_cache(
                self.cfg, nat, self._empty_row(), [P]))
            otrace.stop_timer()
            return int(out[0]) if greedy else \
                self._sample_safe(req, self._host_logits(out[0]))
        self._write_slot(slot, self._empty_row())
        if not req.prompt:
            # degenerate empty prompt: argmax of a zero logits row
            return 0 if greedy else self._sample_safe(
                req, np.zeros((self.cfg.vocab_size,), np.float32))
        decode = self._decode_tok if greedy else self._decode_lg
        rows = torch.tensor([slot], device=self.device)
        toks = np.zeros((self.slots, 1), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        for t, tok in enumerate(req.prompt):
            toks[slot, 0] = tok
            pos[slot] = t
            out, _ = decode(self.params, self._ints(toks), self._ints(pos),
                            self.cache, rows)
        otrace.stop_timer()
        return int(out[slot]) if greedy else \
            self._sample_safe(req, self._host_logits(out[slot]))

    def _paged_prefill_slot(self, slot: int, req: Request, adm):
        """Prefix-reusing prefill: wire the slot's block table from the
        Admission (shared radix pages + CoW clone + fresh pages), then run
        only the uncached suffix through the model — one bulk forward or
        len(suffix) decode steps. Returns the first generated token."""
        greedy = req.sampling.is_greedy
        self._wire_slot_table(slot, adm)
        start, P = adm.n_reused, len(req.prompt)
        self.prefill_tokens_computed += P - start
        if not req.prompt:
            # degenerate empty prompt: argmax of a zero logits row
            return 0 if greedy else self._sample_safe(
                req, np.zeros((self.cfg.vocab_size,), np.float32))
        if self.prefill_mode == "bulk":
            suffix = req.prompt[start:]
            Sb = bucket_len(len(suffix), self.cache_len)
            toks = self._ints([suffix + [0] * (Sb - len(suffix))])
            prefill = self._prefill_tok if greedy else self._prefill_lg
            out, _ = prefill(self.params, toks, start, len(suffix),
                             self.cache, self._ints(self.table[slot]))
            otrace.stop_timer()
            first = int(out) if greedy else \
                self._sample_safe(req, self._host_logits(out))
        else:
            decode = self._decode_tok if greedy else self._decode_lg
            # peers' rows masked to the null block: their lockstep garbage
            # writes must not touch live pages
            tbl = np.zeros_like(self.table)
            tbl[slot] = self.table[slot]
            tbl = self._ints(tbl)
            toks = np.zeros((self.slots, 1), np.int32)
            pos = np.zeros((self.slots,), np.int32)
            for t in range(start, P):
                toks[slot, 0] = req.prompt[t]
                pos[slot] = t
                out, _ = decode(self.params, self._ints(toks),
                                self._ints(pos), self.cache, tbl)
            otrace.stop_timer()
            first = int(out[slot]) if greedy else \
                self._sample_safe(req, self._host_logits(out[slot]))
        # index the prompt's full pages: the next request sharing this
        # prefix reuses them instead of re-running prefill
        self.manager.commit(req.prompt, self._slot_blocks[slot])
        return first

    def _release_slot_blocks(self, slot: int, req: Optional[Request],
                             commit: bool = True):
        """When a slot empties: optionally index the sequence written so
        far (prompt + generated full pages) for future prefix reuse, then
        drop the request's block references — pages the radix tree kept
        stay resident, the rest return to the pool."""
        blocks = self._slot_blocks[slot]
        if not blocks:
            return
        if commit and req is not None:
            written = (req.prompt + req.output)[:int(self.pos[slot]) + 1]
            self.manager.commit(written, blocks)
        self.manager.release(blocks)
        self._slot_blocks[slot] = []
        self.table[slot, :] = 0

    def _retire(self, slot: int):
        req = self.active[slot]
        with otrace.span("engine.retire", tid=self.trace_tid, slot=slot,
                         request=req.request_id):
            req.done = True
            if self.scheduler is not None:
                self.scheduler.drop(slot)    # no-op unless mid-prefill
            self._release_slot_blocks(slot, req)
            self.active[slot] = None
            self.pos[slot] = -1
            if self.retain_finished:
                self._finished.append(req)
            if self.on_finish:
                self.on_finish(req)

    # ------------------------------------------------------------- run
    def step(self) -> int:
        """Admit + one lockstep decode over active slots. Returns the number
        of slots that took part. On a chunked engine a step with a prompt in
        flight is one mixed decode + chunk dispatch; otherwise an all-
        greedy batch takes the speculative lane (spec_tokens > 0) or the
        fused lane (fused_tokens > 1), and anything else one single-token
        step, in the reference's order. Runs on the engine's stream."""
        with self._on_stream():
            return self._step()

    def _step(self) -> int:
        self._admit()
        if self.scheduler is not None and self.scheduler.has_prefill_work():
            return self._step_mixed()
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return 0
        toks = np.zeros((self.slots, 1), np.int32)
        for s in live:
            toks[s, 0] = self.active[s].output[-1]
        pos = np.maximum(self.pos + 1, 0).astype(np.int32)
        greedy_batch = all(self.active[s].sampling.is_greedy for s in live)
        if self._decode_spec is not None and greedy_batch \
                and not self.degraded:
            return self._step_spec(live, toks, pos)
        if self._decode_fused is not None and greedy_batch and \
                not self.degraded and \
                2 * max(self.budget[s] for s in live) > self.fused_tokens:
            # request endgame guard: the fused dispatch always runs
            # fused_tokens full forwards, so once every live slot would go
            # dead within the first half of the burst, the wasted null-page
            # forwards cost more than the host round trips saved
            return self._step_fused(live, toks, pos)
        t0 = time.perf_counter()
        # one token per live slot this dispatch; read blocks before the
        # reconcile loop can retire slots and release them
        shares = [(self.active[s].request_id, 1, self._blocks_held(s))
                  for s in live]
        with otrace.span("engine.step", tid=self.trace_tid, step="decode",
                         live=len(live)) as span:
            timer = otrace.device_timer(self.device, EAGER_TIMING_EVERY)
            decode = self._decode_tok if greedy_batch else self._decode_lg
            with otrace.span("device.decode", tid=self.trace_tid,
                             kind="single", greedy=greedy_batch):
                if self.kv_layout == "paged":
                    # every live slot scatters exactly into its own
                    # frontier page; empty slots' zero tables hit the
                    # null block
                    out, _ = decode(self.params, self._ints(toks),
                                    self._ints(pos), self.cache,
                                    self._ints(self.table))
                else:
                    # only the live slots' cache rows are written
                    out, _ = decode(self.params, self._ints(toks),
                                    self._ints(pos), self.cache,
                                    torch.tensor(live, device=self.device))
                timer.stop()
                otrace.fence((out, self.cache))
            out = out.cpu().numpy() if greedy_batch else \
                out.float().cpu().numpy()
            timer.attach(span)
            with otrace.span("engine.reconcile", tid=self.trace_tid,
                             step="decode", live=len(live)):
                for s in live:
                    req = self.active[s]
                    self.pos[s] += 1
                    self.budget[s] -= 1
                    tok = int(out[s]) if greedy_batch else \
                        self._sample_safe(req, out[s])
                    if isinstance(tok, Exception):
                        self.budget[s] = 0
                        self._retire(s)
                        continue
                    hit_eos = req.eos_id is not None and tok == req.eos_id
                    if not hit_eos:
                        self._emit(req, tok)
                    if hit_eos or self.budget[s] <= 0:
                        self._retire(s)
        self._observe_step("decode", t0, shares)
        return len(live)

    def _step_mixed(self) -> int:
        """One chunked-scheduler iteration: lockstep single-token decode over
        every decoding slot plus one bounded prefill chunk of the
        scheduler's head prefilling slot, in one `build_mixed_step`
        dispatch. Decoding slots advance as in `step()`; the chunk moves
        its slot's cursor, radix-commits the prompt's newly completed
        pages, and when it completes the prompt samples the deferred first
        token from the chunk's last-position logits."""
        t0 = time.perf_counter()
        with otrace.span("engine.step", tid=self.trace_tid, step="mixed"):
            n, shares = self._step_mixed_impl()
        self._observe_step("mixed", t0, shares)
        return n

    def _step_mixed_impl(self):
        sched = self.scheduler
        plan = sched.plan_chunk(
            {s: self.active[s].prompt for s in range(self.slots)
             if self.active[s] is not None and sched.prefilling(s)})
        decode_live = [s for s in range(self.slots)
                       if self.active[s] is not None
                       and not sched.prefilling(s)]
        creq = self.active[plan.slot]
        # ledger shares: each decoding slot gets one token, the chunk slot
        # its chunk length; blocks read before the reconcile loop retires
        shares = [(self.active[s].request_id, 1, self._blocks_held(s))
                  for s in decode_live]
        shares.append((creq.request_id, len(plan.tokens),
                       self._blocks_held(plan.slot)))
        toks = np.zeros((self.slots, 1), np.int32)
        for s in decode_live:
            toks[s, 0] = self.active[s].output[-1]
        pos = np.maximum(self.pos + 1, 0).astype(np.int32)
        # prefilling (and empty) slots' table rows are masked to the null
        # block: their lockstep decode writes must never touch live pages
        tbl = np.zeros_like(self.table)
        for s in decode_live:
            tbl[s] = self.table[s]
        ctoks = np.zeros((1, sched.chunk_budget), np.int32)
        ctoks[0, :len(plan.tokens)] = plan.tokens
        # the chunk attends only pages up to its own end: a truncated
        # table, its page count rounded up to a power of two as in the
        # reference, so both gather the same span
        nbp = -(-(plan.start + len(plan.tokens)) // self.block_size)
        nbp = min(bucket_len(nbp, 0), self.table.shape[1])
        greedy_batch = all(self.active[s].sampling.is_greedy
                           for s in decode_live)
        need_logits = (bool(decode_live) and not greedy_batch) or \
            (plan.completes and not creq.sampling.is_greedy)
        mixed = self._mixed_lg if need_logits else self._mixed_tok
        with otrace.span("device.mixed", tid=self.trace_tid,
                         decoding=len(decode_live), chunk=len(plan.tokens)):
            out_d, out_c, _ = mixed(
                self.params, self._ints(toks), self._ints(pos), self.cache,
                self._ints(tbl), self._ints(ctoks), plan.start,
                len(plan.tokens), self._ints(self.table[plan.slot, :nbp]))
            otrace.fence((out_d, out_c, self.cache))
        sched.mixed_dispatches += 1
        if need_logits:
            out_d, out_c = out_d.float().cpu().numpy(), \
                out_c.float().cpu().numpy()
        else:
            out_d, out_c = out_d.cpu().numpy(), int(out_c)
        for s in decode_live:
            req = self.active[s]
            self.pos[s] += 1
            self.budget[s] -= 1
            tok = self._sample_safe(req, out_d[s]) if need_logits \
                else int(out_d[s])
            if isinstance(tok, Exception):
                self.budget[s] = 0
                self._retire(s)
                continue
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if not hit_eos:
                self._emit(req, tok)
            if hit_eos or self.budget[s] <= 0:
                self._retire(s)
        # chunk reconciliation: cursor forward, commit at the boundary
        sched.advance(plan)
        self.prefill_tokens_computed += len(plan.tokens)
        cur = plan.start + len(plan.tokens)
        self.manager.commit(creq.prompt[:cur], self._slot_blocks[plan.slot])
        if plan.completes:
            first = self._sample_safe(creq, out_c) if need_logits \
                else out_c
            self._finish_prefill(plan.slot, creq, first)
        return len(decode_live) + 1, shares

    def _step_fused(self, live, toks, pos) -> int:
        """One fused dispatch: up to fused_tokens greedy decode steps (one
        CUDA graph replay on the card). EOS and per-slot budgets are
        masked on the device (a dead slot's writes go to the null page);
        this method reconciles the device's view back into host
        bookkeeping: tokens emitted per slot, pos/budget advanced by the
        steps taken, finished slots retired."""
        t0 = time.perf_counter()
        with otrace.span("engine.step", tid=self.trace_tid, step="fused",
                         live=len(live), fused_tokens=self.fused_tokens) \
                as span:
            n, shares = self._step_fused_impl(live, toks, pos, span)
        self._observe_step("fused", t0, shares)
        return n

    def _step_fused_impl(self, live, toks, pos, span):
        timer = otrace.device_timer(self.device)
        eos = np.full((self.slots,), -1, np.int32)
        steps = np.zeros((self.slots,), np.int32)
        alive = np.zeros((self.slots,), bool)
        for s in live:
            req = self.active[s]
            if req.eos_id is not None:
                eos[s] = req.eos_id
            steps[s] = self.budget[s]
            alive[s] = True
        with otrace.span("device.fused", tid=self.trace_tid, live=len(live)):
            emitted, live_out, steps_out, _ = self._decode_fused(
                self.params, self._ints(toks), self._ints(pos), self.cache,
                self._ints(self.table), self._ints(eos),
                torch.as_tensor(alive, device=self.device),
                self._ints(steps))
            timer.stop()
            otrace.fence((emitted, self.cache))
        emitted = emitted.cpu().numpy()
        live_out = live_out.cpu().numpy()
        steps_out = steps_out.cpu().numpy()
        timer.attach(span)
        shares = []
        with otrace.span("engine.reconcile", tid=self.trace_tid,
                         step="fused", live=len(live)):
            for s in live:
                req = self.active[s]
                used = int(steps[s] - steps_out[s])
                # ledger share = steps this slot actually advanced in the
                # burst; blocks read before a possible retire releases
                # them
                shares.append((req.request_id, used, self._blocks_held(s)))
                self.pos[s] += used
                self.budget[s] -= used
                for t in range(emitted.shape[0]):
                    tok = int(emitted[t, s])
                    if tok < 0:
                        break
                    self._emit(req, tok)
                if not live_out[s]:
                    self._retire(s)
        return len(live), shares

    def _step_spec(self, live, toks, pos) -> int:
        """One speculative dispatch: draft K tokens per live slot (host,
        `self.drafter`), verify them all in one batched forward, emit the
        accepted prefix + bonus token, rewind the frontier past the
        rejects. Reconciliation mirrors `_step_fused`, plus the rollback:
        positions beyond pos+adv hold rejected drafts' K/V, and
        `KVCacheManager.rollback` audits the trimmed page range (never
        radix-shared, never freed) and counts it; on the device the rewind
        alone suffices because every read masks beyond the frontier."""
        t0 = time.perf_counter()
        with otrace.span("engine.step", tid=self.trace_tid, step="spec",
                         live=len(live), spec_tokens=self.spec_tokens):
            n, shares = self._step_spec_impl(live, toks, pos)
        self._observe_step("spec", t0, shares)
        return n

    def _step_spec_impl(self, live, toks, pos):
        K = self.spec_tokens
        # packed per-slot operands: draft | eos | steps | live (see builder)
        inp = np.zeros((self.slots, K + 3), np.int32)
        inp[:, K] = -1
        steps = np.zeros((self.slots,), np.int32)
        with otrace.span("draft", tid=self.trace_tid, live=len(live), k=K):
            for s in live:
                req = self.active[s]
                inp[s, :K] = self.drafter.propose(req.prompt + req.output, K)
                if req.eos_id is not None:
                    inp[s, K] = req.eos_id
                inp[s, K + 1] = steps[s] = self.budget[s]
                inp[s, K + 2] = 1
        with otrace.span("device.verify", tid=self.trace_tid,
                         live=len(live)):
            out, _ = self._decode_spec(
                self.params, self._ints(toks), self._ints(pos), self.cache,
                self._ints(self.table), self._ints(inp))
            otrace.fence((out, self.cache))
        out = out.cpu().numpy()         # one packed transfer (see builder)
        emitted, adv, n_acc, live_out, steps_out = \
            out[:K + 1], out[K + 1], out[K + 2], out[K + 3], out[K + 4]
        self.spec_dispatches += 1
        # one O(tree) walk per dispatch, not per rolling-back slot: safe
        # to share across the loop because a retire's commit only indexes
        # the retiring slot's own pages, which can never sit in another
        # slot's (private) rollback range
        shared_blocks = None
        shares = []
        for s in live:
            req = self.active[s]
            p0 = int(pos[s])
            used = int(steps[s] - steps_out[s])
            # ledger share = tokens this slot got out of the verify (the
            # accepted prefix + bonus); blocks read before retire
            shares.append((req.request_id, used, self._blocks_held(s)))
            a = int(adv[s])
            self.spec_tokens_drafted += K
            self.spec_tokens_accepted += min(int(n_acc[s]), K)
            self.spec_tokens_emitted += used
            # the verify forward wrote positions p0..p0+K (span-clamped to
            # the null page); only p0..p0+a survive acceptance
            n_written = min(p0 + K, self.cache_len - 1) + 1
            n_valid = p0 + a + 1
            if n_written > n_valid:
                if shared_blocks is None:
                    shared_blocks = set(self.manager.radix.all_blocks())
                self.manager.rollback(self._slot_blocks[s], n_valid,
                                      n_written, shared=shared_blocks)
                self.spec_tokens_rolled_back += n_written - n_valid
            self.pos[s] = p0 + a
            self.budget[s] -= used
            for t in range(emitted.shape[0]):
                tok = int(emitted[t, s])
                if tok < 0:
                    break
                self._emit(req, tok)
            if not live_out[s]:
                self._retire(s)
        return len(live), shares

    @property
    def spec_metrics(self) -> Optional[dict]:
        """Speculative-decode counters (None when spec is off): drafted vs
        accepted sets the acceptance rate; emitted counts the bonus tokens
        too, so emitted/dispatches is the realized tokens-per-dispatch."""
        if self.spec_tokens <= 0:
            return None
        drafted = self.spec_tokens_drafted
        return {
            "spec_tokens": self.spec_tokens,
            "drafter": getattr(self.drafter, "name", "custom"),
            "dispatches": self.spec_dispatches,
            "tokens_drafted": drafted,
            "tokens_accepted": self.spec_tokens_accepted,
            "tokens_emitted": self.spec_tokens_emitted,
            "tokens_rolled_back": self.spec_tokens_rolled_back,
            "acceptance_rate": (self.spec_tokens_accepted / drafted
                                if drafted else 0.0),
            "tokens_per_dispatch": (self.spec_tokens_emitted
                                    / self.spec_dispatches
                                    if self.spec_dispatches else 0.0),
        }

    @property
    def scheduler_metrics(self) -> Optional[dict]:
        """Chunked-prefill scheduler counters (None on the phased path):
        chunks and tokens dispatched, prefills started / completed / in
        flight, realized tokens per chunk."""
        return self.scheduler.metrics() if self.scheduler is not None \
            else None

    def run(self) -> List[Request]:
        """Drive to completion and return finished requests. Works even on
        an engine whose frontend disabled retain_finished (requests that
        finish inside this call are tracked and returned either way)."""
        retain, self.retain_finished = self.retain_finished, True
        start = len(self._finished)
        try:
            while self._pending or any(a is not None for a in self.active):
                self.step()
        finally:
            self.retain_finished = retain
        if retain:
            return list(self._finished)
        done, self._finished[start:] = self._finished[start:], []
        return done

    def evict(self, req: Request) -> bool:
        """Drop a request from this engine (pending or mid-decode) without
        marking it done — the gateway uses this when re-dispatching leased
        work away from a failed replica. Returns True if found."""
        if req in self._pending:
            self._pending.remove(req)
            return True
        for slot in range(self.slots):
            if self.active[slot] is req:
                if self.scheduler is not None:
                    # half-prefilled: forget its cursor/queue position too
                    self.scheduler.drop(slot)
                # replica is being failed out: don't index its pages
                # (state is suspect), just return the references
                self._release_slot_blocks(slot, req, commit=False)
                self.active[slot] = None
                self.pos[slot] = -1
                return True
        return False
