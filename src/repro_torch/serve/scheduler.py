"""Chunked-prefill token-budget scheduler: stall-free continuous batching.

The port's copy of `repro.serve.scheduler`, which is host-only: the code is
the reference's, line for line.

The phased engine admits a request and prefills its whole prompt in one
monolithic forward before the next decode step — every decoding slot
stalls for the full prompt length, a head-of-line-blocking latency cliff
that grows with prompt diversity. This module is the host-side brain of
the alternative: each engine step assembles a *mixed batch* of one decode
token per decoding slot plus up to ``chunk_budget`` prefill tokens sliced
from an in-flight prompt, dispatched together through
``serve/step.build_mixed_step``. Prefill piggybacks on the decode
dispatches the batch was going to pay anyway; no slot ever waits out a
whole prompt.

The scheduler owns only bookkeeping — which slots are mid-prefill, where
each prompt's cursor stands, whose turn the next chunk is — and hands the
engine a :class:`ChunkPlan` per step. Device work stays in the engine
(the split mirrors ``kvcache.KVCacheManager``: host-side decisions are
plain-Python testable, the engine performs the device ops).

Scheduling policy: prefilling slots queue FCFS; each step the head slot
receives one chunk of ``min(chunk_budget, remaining)`` tokens, then
rotates to the tail if its prompt is still incomplete. Round-robin keeps
concurrent long prompts advancing together instead of serializing, and
one chunk per dispatch keeps the device shapes fixed (one jit trace
serves every chunk size via right-padding). Chunk boundaries are also
the radix-commit points: after each chunk the engine indexes the prompt's
newly completed pages, so a second request sharing the prefix can reuse
them while the first is still prefilling.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

SCHEDULERS = ("phased", "chunked")


@dataclass
class ChunkPlan:
    """One step's prefill assignment: run `tokens` (real, unpadded) of
    `slot`'s prompt starting at absolute position `start`. `completes` is
    True when the chunk reaches the end of the prompt — the engine must
    then read the chunk's last-position logits (the deferred first token)
    and flip the slot to decoding."""
    slot: int
    start: int
    tokens: List[int]
    completes: bool


class ChunkedScheduler:
    """Token-budget iteration scheduler over partially-prefilled slots."""

    name = "chunked"

    def __init__(self, chunk_budget: int):
        if chunk_budget < 1:
            raise ValueError(f"chunk_budget must be >= 1, got {chunk_budget}")
        self.chunk_budget = int(chunk_budget)
        # brownout throttle: a cap BELOW chunk_budget on how many tokens a
        # chunk carries. Separate from chunk_budget on purpose — the jitted
        # mixed step pads its chunk operand to chunk_budget width, so the
        # budget itself must never change post-construction (it would
        # retrace); the cap only shortens the real token run inside it
        self._cap: Optional[int] = None
        # slot -> prompt tokens already resident (reused prefix + chunks)
        self._cursor: Dict[int, int] = {}
        self._fifo: List[int] = []          # prefilling slots, FCFS order
        # telemetry (engine.scheduler_metrics -> gateway dashboard)
        self.mixed_dispatches = 0
        self.chunks_dispatched = 0
        self.prefill_tokens_chunked = 0
        self.prefills_started = 0
        self.prefills_completed = 0

    # ------------------------------------------------------------ lifecycle
    def admit(self, slot: int, n_reused: int):
        """A request entered `slot` with `n_reused` prompt tokens already
        resident (radix prefix hit); its remaining prompt will be chunked."""
        self._cursor[slot] = n_reused
        self._fifo.append(slot)
        self.prefills_started += 1

    def drop(self, slot: int):
        """The slot emptied mid-prefill (eviction / request-scoped failure)
        or finished its prompt; forget it. Idempotent."""
        if slot in self._cursor:
            del self._cursor[slot]
            self._fifo.remove(slot)

    def throttle(self, cap: Optional[int]):
        """Set (or clear, with None) the brownout chunk cap. Clamped to
        [1, chunk_budget]."""
        self._cap = None if cap is None else max(1, min(int(cap),
                                                        self.chunk_budget))

    # ------------------------------------------------------------- planning
    def prefilling(self, slot: int) -> bool:
        return slot in self._cursor

    def cursor(self, slot: int) -> Optional[int]:
        return self._cursor.get(slot)

    def has_prefill_work(self) -> bool:
        return bool(self._fifo)

    def plan_chunk(self, prompts: Dict[int, List[int]]) -> Optional[ChunkPlan]:
        """Pick the next chunk under the token budget: the FCFS head slot
        gets min(chunk_budget, remaining) tokens. `prompts` maps slot ->
        full prompt for every prefilling slot."""
        if not self._fifo:
            return None
        slot = self._fifo[0]
        prompt = prompts[slot]
        cur = self._cursor[slot]
        budget = self.chunk_budget if self._cap is None else self._cap
        n = min(budget, len(prompt) - cur)
        return ChunkPlan(slot=slot, start=cur, tokens=list(prompt[cur:cur + n]),
                         completes=cur + n >= len(prompt))

    def advance(self, plan: ChunkPlan):
        """The engine dispatched `plan`: move the cursor past the chunk and
        either retire the slot from the prefill queue (prompt complete) or
        rotate it to the tail so peers share the budget round-robin."""
        self.chunks_dispatched += 1
        self.prefill_tokens_chunked += len(plan.tokens)
        self._cursor[plan.slot] += len(plan.tokens)
        assert self._fifo[0] == plan.slot, "advance must follow plan_chunk"
        self._fifo.pop(0)
        if plan.completes:
            del self._cursor[plan.slot]
            self.prefills_completed += 1
        else:
            self._fifo.append(plan.slot)

    # ------------------------------------------------------------ telemetry
    def metrics(self) -> dict:
        return {
            "scheduler": self.name,
            "chunk_budget": self.chunk_budget,
            "chunk_cap": self._cap,
            "mixed_dispatches": self.mixed_dispatches,
            "chunks_dispatched": self.chunks_dispatched,
            "prefill_tokens_chunked": self.prefill_tokens_chunked,
            "prefills_started": self.prefills_started,
            "prefills_completed": self.prefills_completed,
            "prefills_in_flight": len(self._fifo),
            "tokens_per_chunk": (self.prefill_tokens_chunked
                                 / self.chunks_dispatched
                                 if self.chunks_dispatched else 0.0),
        }
