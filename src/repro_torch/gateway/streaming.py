"""Per-request token streams for the serving gateway.

A TokenStream is the caller-facing view of one request's decode: tokens are
pushed by the gateway as the engine emits them, and the caller consumes them
either through an `on_token` callback (fires inline with the decode step) or
by iterating. Iteration is pull-based: when the buffer is empty the stream
invokes its `pump` (the gateway's `step`) to advance the engines until a new
token lands or the request finishes — so `for tok in req.stream:` observes
tokens as they decode rather than after `run()` returns.

Delivery across failures is *exactly-once at the consumer's cursor*: when a
replica dies mid-decode and the request is re-leased, the retry restarts
generation from token 0, but the stream records how many tokens the consumer
has already seen (`delivered`) and swallows that many replayed tokens before
making new ones visible. The consumer observes an explicit `restarted` event
in `stream.events` and then a seamless continuation — never a duplicated
prefix. This requires the retry to regenerate the same prefix, which holds
for greedy decoding and for seeded per-request sampling (both true here);
a nondeterministic sampler would make the post-restart suffix diverge.

Thread-safety (async workers): a stream's producer is always a single
thread at a time (the owning replica's worker, or the gateway lifecycle
code — all under the gateway lock), but the *consumer* may be any thread
iterating the stream. An internal lock guards the buffer and cursors;
the user `on_token` callback is invoked OUTSIDE it, because a callback is
allowed to call back into the gateway (e.g. submit a follow-up request)
and the gateway lock must stay above the stream lock in the acquisition
order. Single-producer ordering keeps callback invocations in token
order even without the lock held across the call.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional


class TokenStream:
    def __init__(self, pump: Optional[Callable[[], int]] = None,
                 on_token: Optional[Callable[[int], None]] = None):
        self._mu = threading.RLock()
        self._buf: deque = deque()
        self._done = False
        self._pump = pump
        self._cb = on_token
        self.callback_error: Optional[BaseException] = None
        # terminal event metadata: why the stream ended. None for a normal
        # completion; admission control sets ("over_capacity", 429) — the
        # HTTP-shaped signal a frontend would surface as Too Many Requests
        self.finish_reason: Optional[str] = None
        self.status_code: Optional[int] = None
        # restart bookkeeping: tokens the consumer has provably seen via
        # each path, replayed tokens still to swallow, and the event log
        # ("restarted" markers) a consumer can inspect mid-iteration
        self._cb_seen = 0
        self._popped = 0
        self._replay_skip = 0
        self.restarts = 0
        self.events: List[dict] = []

    # ------------------------------------------------------- producer side
    def push(self, tok: int):
        with self._mu:
            if self._replay_skip > 0:
                # a post-restart retry re-emits from token 0; this prefix
                # was already delivered before the failure — swallow it
                self._replay_skip -= 1
                return
            self._buf.append(tok)
            cb = self._cb
            if cb:
                self._cb_seen += 1
        if cb:
            try:
                cb(tok)
            except Exception as err:  # noqa: BLE001
                # a client callback bug must not look like replica failure
                # (it would poison every replica in turn as the request
                # retries); disable the callback, keep the error and keep
                # decoding — the buffered/iterator path still works
                with self._mu:
                    self.callback_error = err
                    self._cb = None

    def finish(self, reason: Optional[str] = None,
               code: Optional[int] = None):
        """Mark the stream terminal. `reason`/`code` record *why* (e.g.
        ("over_capacity", 429) from token-budget admission control); the
        first terminal event wins."""
        with self._mu:
            if not self._done:
                self.finish_reason = reason
                self.status_code = code
            self._done = True

    def restart(self):
        """Replica-failure retry: drop buffered-but-unread tokens (the
        consumer never saw them; the retry will regenerate them), arm the
        replay cursor to swallow the `delivered` prefix the consumer DID
        see, and log an explicit `restarted` event."""
        with self._mu:
            self._buf.clear()
            self._replay_skip = self.delivered
            self.restarts += 1
            self.events.append({"event": "restarted",
                                "visible_tokens": self.delivered})

    # legacy name; same semantics (pre-restart callers expected "re-emit
    # from the start", which silently duplicated the delivered prefix)
    reset = restart

    # ------------------------------------------------------- consumer side
    @property
    def delivered(self) -> int:
        """Tokens the consumer has visibly received. With a callback armed
        the callback is the visibility cursor; otherwise the iterator/drain
        cursor is. (Consuming through BOTH is ambiguous — the larger cursor
        wins, so replay never duplicates for the faster consumer.)"""
        with self._mu:
            return max(self._cb_seen, self._popped)

    @property
    def finished(self) -> bool:
        with self._mu:
            return self._done and not self._buf

    def drain(self) -> List[int]:
        """Non-blocking: all tokens buffered so far."""
        with self._mu:
            out = list(self._buf)
            self._buf.clear()
            self._popped += len(out)
            return out

    def __iter__(self):
        return self

    def __next__(self) -> int:
        # the pump runs OUTSIDE the stream lock: it is the gateway's step,
        # which takes the gateway lock, and gateway -> stream is the
        # established acquisition order (holding stream here would invert
        # it). The buffer is re-checked under the lock each pass.
        while True:
            with self._mu:
                if self._buf:
                    self._popped += 1
                    return self._buf.popleft()
                if self._done or self._pump is None:
                    raise StopIteration
            if self._pump() <= 0:
                with self._mu:
                    if self._buf or self._done:
                        continue
                raise RuntimeError(
                    "TokenStream stalled: gateway made no progress but the "
                    "request is not finished (rejected/dead-lettered?)")
