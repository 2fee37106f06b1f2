"""Per-tenant/per-tier utilization ledger: who consumed the device.

The SLO tracker (PR 7) judges *outcomes* — did tenant X's requests meet
their tier's latency targets — but nothing answers the cost question:
how much device time did tenant X consume earning those outcomes? This
ledger is the cost denominator. Every engine dispatch reports its
measured wall time plus the slots that rode it (as ``(request_id,
tokens, blocks)`` shares); the ledger splits the step's seconds across
the shares **by token share**, attributing co-batched work in proportion
to what each request actually got out of the dispatch. KV pressure is
integrated the same way: each share's held blocks x step seconds
accumulate as block-seconds, and the pool's total allocated blocks
integrate as pool-block-seconds (occupancy over time, not a point
sample).

Conservation is exact by construction: the per-share split assigns the
floating-point remainder to the last share, so the sum of attributed
device-seconds equals the sum of reported step times to the ulp — the
property `bench_obs` bars at 1%, where the slack covers pipeline
completeness (steps that never report), not float drift.

Requests are mapped to tenants by `tag()` at gateway placement time;
work from an untagged request (direct engine use, tests) lands under
``(untagged)``, and a step that reports no shares (empty live set)
under ``(idle)`` — the ledger never silently drops device time.

Lock discipline: `_mu` is a leaf (audited by `audit_serving_stack`);
`record_step` is called from engine step paths outside any gateway lock.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Tuple

Share = Tuple[object, int, int]     # (request_id, tokens, blocks_held)

UNTAGGED = "(untagged)"
IDLE = "(idle)"


class _TenantRow:
    __slots__ = ("tier", "device_s", "tokens", "block_s", "steps")

    def __init__(self, tier: Optional[int]):
        self.tier = tier
        self.device_s = 0.0
        self.tokens = 0
        self.block_s = 0.0
        self.steps = 0


class UtilizationLedger:
    """Attribute engine step time + KV occupancy to tenants and tiers."""

    def __init__(self):
        self._mu = threading.Lock()
        self._owner: Dict[object, Tuple[str, Optional[int]]] = {}
        self._tenants: Dict[str, _TenantRow] = {}
        self._by_kind: Dict[str, float] = {}
        self.steps = 0
        self.total_device_s = 0.0
        self.pool_block_s = 0.0

    # ------------------------------------------------------------- tagging
    def tag(self, request_id, tenant: Optional[str], tier: Optional[int]):
        """Bind a request to its tenant/tier (called at gateway placement;
        idempotent, last write wins on requeue)."""
        with self._mu:
            self._owner[request_id] = (tenant or UNTAGGED, tier)

    # ----------------------------------------------------------- recording
    def record_step(self, kind: str, seconds: float,
                    shares: Iterable[Share], *, pool_blocks: int = 0):
        """Attribute one dispatch's measured wall time.

        `shares` lists the slots that rode the dispatch as
        ``(request_id, tokens, blocks_held)``; the step's seconds split
        across them proportionally to tokens (equal split if every token
        count is 0 — a prefill that computed nothing new still occupied
        the dispatch). The remainder after per-share rounding goes to the
        last share so totals conserve exactly.
        """
        seconds = float(seconds)
        shares = [(rid, max(0, int(tok)), max(0, int(blk)))
                  for rid, tok, blk in shares]
        with self._mu:
            self.steps += 1
            self.total_device_s += seconds
            self._by_kind[kind] = self._by_kind.get(kind, 0.0) + seconds
            self.pool_block_s += pool_blocks * seconds
            if not shares:
                self._row(IDLE, None).device_s += seconds
                self._row(IDLE, None).steps += 1
                return
            total_tok = sum(tok for _, tok, _ in shares)
            attributed = 0.0
            for i, (rid, tok, blk) in enumerate(shares):
                tenant, tier = self._owner.get(rid, (UNTAGGED, None))
                row = self._row(tenant, tier)
                if i == len(shares) - 1:
                    part = seconds - attributed     # exact conservation
                elif total_tok > 0:
                    part = seconds * (tok / total_tok)
                else:
                    part = seconds / len(shares)
                attributed += part
                row.device_s += part
                row.tokens += tok
                row.block_s += blk * seconds
                row.steps += 1

    def _row(self, tenant: str, tier: Optional[int]) -> _TenantRow:
        row = self._tenants.get(tenant)
        if row is None:
            row = self._tenants[tenant] = _TenantRow(tier)
        elif row.tier is None and tier is not None:
            row.tier = tier
        return row

    # ------------------------------------------------------------ reporting
    def report(self) -> dict:
        """The ledger as one dict (also the ``ledger`` registry scope):
        totals, conservation error, per-tenant and per-tier splits, and
        device time by step kind."""
        with self._mu:
            total = self.total_device_s
            attributed = sum(r.device_s for r in self._tenants.values())
            err = abs(attributed - total) / total if total > 0 else 0.0
            tenants = {}
            tiers: Dict[str, dict] = {}
            for name, r in sorted(self._tenants.items()):
                frac = r.device_s / total if total > 0 else 0.0
                tenants[name] = {"tier": r.tier, "device_s": r.device_s,
                                 "frac": frac, "tokens": r.tokens,
                                 "block_s": r.block_s, "steps": r.steps}
                tkey = str(r.tier) if r.tier is not None else "-"
                t = tiers.setdefault(tkey, {"device_s": 0.0, "tokens": 0,
                                            "block_s": 0.0})
                t["device_s"] += r.device_s
                t["tokens"] += r.tokens
                t["block_s"] += r.block_s
            return {"steps": self.steps,
                    "total_device_s": total,
                    "attributed_device_s": attributed,
                    "conservation_err_frac": err,
                    "pool_block_s": self.pool_block_s,
                    "by_kind": dict(sorted(self._by_kind.items())),
                    "tenants": tenants,
                    "tiers": tiers}

    def stats(self) -> Optional[dict]:
        """Registry-scope provider (None before any step so the scope is
        omitted while the feature is idle)."""
        return self.report() if self.steps else None
