"""Draft-token proposers for speculative decoding, the port of
`repro.serve.draft`.

Speculative decoding splits each decode step into *propose* (a cheap guess
of the next K tokens) and *verify* (one batched forward of the real model
over all K guesses, `serve.step.build_decode_spec`). The drafter only sets
the acceptance rate: the verify pass accepts exactly the prefix of guesses
the target model would itself have produced, so no drafter changes an
output.

  * `NGramDrafter`: self-speculative prompt lookup, host-only, the
    reference's code line for line.
  * `ModelDrafter`: a small draft LM proposes greedily, on the port's dense
    `build_decode`, `build_prefill_bucketed` and `prefill_into_cache`, on
    the device its weights lie on.

`make_drafter` is the string-spec factory the engine uses: "ngram",
"ngram:<n>", "model:<arch_id>" (the port's registry, reduced config,
random weights from a seeded `torch.Generator`; they differ from the
reference's `PRNGKey(0)` draw, so parity tests pass a `ModelDrafter` built
on bridged weights instead).
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Sequence

import torch


class Drafter(Protocol):
    """Proposes `k` draft tokens continuing `ctx` (prompt + output so
    far). Must return exactly k ints and must be deterministic: the verify
    pass guarantees correctness, the drafter only sets the acceptance
    rate."""
    name: str

    def propose(self, ctx: Sequence[int], k: int) -> List[int]: ...


class NGramDrafter:
    """Prompt-lookup decoding: find the latest earlier occurrence of the
    context's trailing n-gram (longest n first) and propose the tokens
    that followed it. Falls back to repeating the last token when nothing
    matches — a wrong guess costs one rejected draft, never a wrong
    output."""

    def __init__(self, n: int = 3):
        if n < 1:
            raise ValueError("ngram order must be >= 1")
        self.n = n
        self.name = f"ngram:{n}"

    def propose(self, ctx: Sequence[int], k: int) -> List[int]:
        ctx = list(ctx)
        out: List[int] = []
        if not ctx:
            return [0] * k
        for order in range(min(self.n, len(ctx)), 0, -1):
            pat = ctx[-order:]
            # latest occurrence strictly before the context's own tail
            for i in range(len(ctx) - order - 1, -1, -1):
                if ctx[i:i + order] == pat:
                    out = ctx[i + order:i + order + k]
                    break
            if out:
                break
        while len(out) < k:
            out.append(out[-1] if out else ctx[-1])
        return out[:k]


class ModelDrafter:
    """Greedy draft proposals from a separate (typically much smaller) LM.

    Incremental KV (default): the drafter keeps a small pool of context
    *streams*, (tokens fed, dense decode cache) pairs, and each proposal
    continues the stream sharing the longest prefix with the new context
    instead of prefilling the whole context again. Between rounds a slot's
    context grows by the accepted drafts (which the stream already fed
    while proposing them) plus the bonus token, so the replay tail is
    usually one or two tokens. A rejection never desynchronises a stream:
    positions beyond the replay point are masked by the dense decode read
    (`cache_pos <= pos`) and overwritten as the stream advances again. With
    no stream close enough (a fresh request, or the match was evicted) the
    drafter runs the bucketed bulk prefill, which is the whole story with
    ``incremental=False``.

    The port's dense decode writes its cache in place, so a stream's cache
    is advanced where it lies, as the reference replaces it with its
    successor. `prefill_forwards` / `decode_forwards` / `tokens_fed` count
    the draft model's work."""

    def __init__(self, params, cfg, *, cache_len: int = 1024,
                 name: Optional[str] = None, incremental: bool = True,
                 max_streams: int = 8):
        from repro_torch.serve.step import (build_decode,
                                            build_prefill_bucketed)
        self.params = params
        self.cfg = cfg
        self.device = params["embed"]["table"].device
        self.cache_len = cache_len
        self.name = name or f"model:{cfg.arch_id}"
        self.incremental = incremental
        self.max_streams = max_streams
        self._prefill = build_prefill_bucketed(cfg)
        self._decode = build_decode(cfg)
        self._streams: List[dict] = []      # {"fed", "cache", "tick"}
        self._tick = 0
        self.prefill_forwards = 0
        self.decode_forwards = 0
        self.tokens_fed = 0

    def _ints(self, a) -> torch.Tensor:
        return torch.tensor(a, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------- streams
    def _best_stream(self, ctx: List[int]):
        """Stream with the longest common prefix against `ctx` (ties keep
        the first/oldest — deterministic)."""
        best, best_l = None, 0
        for st in self._streams:
            n = 0
            for a, b in zip(st["fed"], ctx):
                if a != b:
                    break
                n += 1
            if n > best_l:
                best, best_l = st, n
        return best, best_l

    def _store_stream(self, st: Optional[dict], fed: List[int], cache):
        self._tick += 1
        if st is None:
            st = {}
            if len(self._streams) >= self.max_streams:
                # evict the least-recently-used stream slot
                st = min(self._streams, key=lambda s: s["tick"])
            else:
                self._streams.append(st)
        st.update(fed=fed, cache=cache, tick=self._tick)

    # ------------------------------------------------------------- propose
    def propose(self, ctx: Sequence[int], k: int) -> List[int]:
        ctx = list(ctx)
        if not ctx or len(ctx) + k > self.cache_len:
            return list(ctx[-1:] or [0]) * k        # out of draft range
        if self.incremental:
            st, match = self._best_stream(ctx)
            # continuing wins while the replay tail stays shorter than a
            # typical proposal round; past that, one bulk prefill forward
            # beats len(ctx) - match single-token steps
            if st is not None and len(ctx) - match <= max(2 * k + 2, 8):
                return self._propose_incremental(st, ctx, match, k)
        return self._propose_fresh(ctx, k)

    def _propose_fresh(self, ctx: List[int], k: int) -> List[int]:
        from repro_torch.models import transformer as T
        from repro_torch.serve.step import bucket_len, prefill_into_cache
        Sb = bucket_len(len(ctx), self.cache_len)
        toks = self._ints([ctx + [0] * (Sb - len(ctx))])
        first, nat = self._prefill(self.params, {"tokens": toks}, len(ctx))
        self.prefill_forwards += 1
        self.tokens_fed += len(ctx)
        out = [int(first[0])]
        cache = prefill_into_cache(
            self.cfg, nat, T.init_cache(self.cfg, 1, self.cache_len,
                                        self.device), [len(ctx)])
        out, cache = self._extend(cache, len(ctx) - 1, out, k)
        if self.incremental:
            self._store_stream(None, ctx + out[:k - 1], cache)
        return out

    def _propose_incremental(self, st: dict, ctx: List[int], match: int,
                             k: int) -> List[int]:
        """Continue a cached stream: replay only ctx[match:] (at least the
        last context token, whose logits seed the first proposal), then
        decode the remaining k-1 proposals as usual."""
        cache = st["cache"]
        start = min(match, len(ctx) - 1)
        tok = None
        for i in range(start, len(ctx)):
            tok, cache = self._decode(self.params, self._ints([[ctx[i]]]),
                                      self._ints([i]), cache)
            self.decode_forwards += 1
            self.tokens_fed += 1
        out = [int(tok[0])]
        out, cache = self._extend(cache, len(ctx) - 1, out, k)
        self._store_stream(st, ctx + out[:k - 1], cache)
        return out

    def _extend(self, cache, pos: int, out: List[int], k: int):
        """Decode proposals out[1:] greedily, feeding each previous one."""
        while len(out) < k:
            pos += 1
            tok, cache = self._decode(self.params, self._ints([[out[-1]]]),
                                      self._ints([pos]), cache)
            self.decode_forwards += 1
            self.tokens_fed += 1
            out.append(int(tok[0]))
        return out, cache


def make_drafter(spec, *, seed: int = 0, device="cuda") -> "Drafter":
    """Build a drafter from a string spec (or pass an instance through).

    "ngram" / "ngram:<n>"   — self-speculative prompt lookup.
    "model:<arch_id>"       — reduced config from the port's registry,
                              random weights from a `torch.Generator`
                              seeded with `seed`, on `device`; real
                              deployments build a ModelDrafter with
                              trained weights instead.
    """
    if spec is None:
        return NGramDrafter()
    if not isinstance(spec, str):
        return spec
    if spec == "ngram":
        return NGramDrafter()
    if spec.startswith("ngram:"):
        return NGramDrafter(int(spec.split(":", 1)[1]))
    if spec.startswith("model:"):
        from repro_torch.configs import registry
        from repro_torch.models import transformer as T
        cfg = registry.get(spec.split(":", 1)[1], reduced=True)
        gen = torch.Generator(device=device).manual_seed(seed)
        return ModelDrafter(T.init_lm(gen, cfg), cfg, name=spec)
    raise ValueError(f"unknown drafter spec {spec!r} "
                     f"(expected ngram[:n] | model:<arch_id>)")
