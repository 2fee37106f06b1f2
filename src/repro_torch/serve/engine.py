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
engine never moves work to the CPU on its own.

One deliberate difference from the reference: a dense slot is cleared when
a request is admitted into it. The reference's decode-mode prefill leaves
the previous request's recurrent state (RG-LRU or SSM state and conv
window) in the slot, so a recurrent model's tokens depended on what the
slot served before (ROADMAP.md Queue 3); attention entries were already
hidden by their positions.

Not ported yet, and refused with NotImplementedError rather than served
another way: fused multi-token decode, speculative decode and the
chunked-prefill scheduler (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kvcache import KVCacheManager, PoolExhausted
from repro_torch.models import transformer as T
from repro_torch.obs import trace as otrace
from repro_torch.obs.registry import Histogram
from repro_torch.serve.sampler import GREEDY, Sampler, SamplingParams
from repro_torch.serve.step import (build_decode, build_decode_paged,
                                    build_prefill_bucketed,
                                    build_prefill_paged, bucket_len,
                                    prefill_into_cache)

DECODE_KERNELS = ("reference", "cuda")
PREFILL_MODES = ("decode", "bulk")


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


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md Queue 1, "
        f"'{item}'); the port serves single-token decode with the phased "
        "scheduler only")


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
        default) only, as the reference does. `drafter` and
        `chunk_budget` belong to the unported speculative and chunked
        paths and are accepted for signature parity."""
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
        if scheduler not in ("phased", "chunked"):
            raise ValueError(f"scheduler must be phased|chunked, got "
                             f"{scheduler!r}")
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
        if fused_tokens > 1:
            raise _not_ported("fused_tokens > 1",
                              "Fused multi-token decode")
        if spec_tokens > 0:
            raise _not_ported("spec_tokens > 0", "Speculative decode")
        if scheduler == "chunked":
            raise _not_ported("scheduler='chunked'", "Chunked prefill")
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
        self.params = params
        self.cfg = cfg
        self.slots = batch_slots
        self.cache_len = cache_len
        self.kv_layout = kv_layout
        self.decode_kernel = decode_kernel
        self.prefill_mode = prefill_mode
        self.degraded = False
        self.block_size = block_size
        self.manager: Optional[KVCacheManager] = None
        self._slot_blocks: List[List[int]] = [[] for _ in range(batch_slots)]
        # two decode variants: the greedy one argmaxes on the device and
        # moves one int per slot to the host; the logits one feeds host-
        # side per-request sampling
        if kv_layout == "paged":
            nb = cache_len // block_size
            if pool_blocks is None:
                pool_blocks = 2 * batch_slots * nb + 1
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
        else:
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

    @property
    def spec_metrics(self) -> Optional[dict]:
        """Speculative-decode counters; None, as speculation is off."""
        return None

    @property
    def scheduler_metrics(self) -> Optional[dict]:
        """Chunked-scheduler counters; None on the phased path."""
        return None

    # ---------------------------------------------------------- lifecycle
    def reset(self):
        """Warm rebuild for replica reintegration after a crash: device
        cache re-initialized (with a fresh radix index and empty block
        tables on the paged layout), every slot empty. The step closures
        are kept."""
        if self.kv_layout == "paged":
            pool_blocks = self.manager.pool.n_blocks
            self.cache = T.init_paged_cache(self.cfg, pool_blocks,
                                            self.block_size, self.device)
            self.manager = KVCacheManager(pool_blocks, self.block_size)
            self.table = np.zeros_like(self.table)
        else:
            self.cache = T.init_cache(self.cfg, self.slots, self.cache_len,
                                      self.device)
        self._slot_blocks = [[] for _ in range(self.slots)]
        self.pos = np.full((self.slots,), -1, np.int64)
        self.budget = np.zeros((self.slots,), np.int64)
        self.active = [None] * self.slots
        self._pending = []
        self._finished = []
        self.prefill_tokens_computed = 0

    def set_degraded(self, on: bool, *, chunk_cap: int = 8):
        """Brownout level-2 lever. The reference parks its fused and
        speculative lanes and caps chunked-prefill chunks; the port has
        none of those yet, so only the flag is kept (`chunk_cap` is
        accepted for signature parity)."""
        self.degraded = bool(on)

    # ------------------------------------------------------------- internals
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
                         reused=(adm.n_reused if adm is not None else 0)):
            if adm is not None:
                first = self._paged_prefill_slot(slot, req, adm)
            else:
                first = self._dense_prefill_slot(slot, req)
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
            self._release_slot_blocks(slot, req)
            self.active[slot] = None
            self.pos[slot] = -1
            if self.retain_finished:
                self._finished.append(req)
            if self.on_finish:
                self.on_finish(req)

    # ------------------------------------------------------------- run
    def step(self) -> int:
        """Admit + one lockstep single-token decode over active slots.
        Returns the number of slots that decoded."""
        self._admit()
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return 0
        toks = np.zeros((self.slots, 1), np.int32)
        for s in live:
            toks[s, 0] = self.active[s].output[-1]
        pos = np.maximum(self.pos + 1, 0).astype(np.int32)
        greedy_batch = all(self.active[s].sampling.is_greedy for s in live)
        t0 = time.perf_counter()
        # one token per live slot this dispatch; read blocks before the
        # reconcile loop can retire slots and release them
        shares = [(self.active[s].request_id, 1, self._blocks_held(s))
                  for s in live]
        with otrace.span("engine.step", tid=self.trace_tid, step="decode",
                         live=len(live)):
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
                otrace.fence((out, self.cache))
            out = out.cpu().numpy() if greedy_batch else \
                out.float().cpu().numpy()
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
                # replica is being failed out: don't index its pages
                # (state is suspect), just return the references
                self._release_slot_blocks(slot, req, commit=False)
                self.active[slot] = None
                self.pos[slot] = -1
                return True
        return False
