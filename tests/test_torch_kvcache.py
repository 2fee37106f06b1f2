"""The port's copy of the host-side KV-cache manager (repro_torch.kvcache)
against the reference's (repro.kvcache): both driven by the same seeded
sequence of admissions, copy-on-write completions, commits, releases and
rollbacks under pool pressure. Every result — admissions (blocks, reused
length, CoW pair), refusals, evictions, rollback verdicts, counters and the
final pool state — must be identical.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro import kvcache as jkv  # noqa: E402
from repro_torch import kvcache as tkv  # noqa: E402

BS = 4


def _drive(kv, seed, n_ops=300):
    rng = np.random.default_rng(seed)
    mgr = kv.KVCacheManager(18, BS)
    live = []                  # (tokens written, blocks)
    log = []
    for _ in range(n_ops):
        op = rng.integers(0, 10)
        if op < 5 or not live:
            # a small alphabet, so prompts share prefixes and part pages
            prompt = [int(t) for t in rng.integers(0, 3, rng.integers(1, 13))]
            total = len(prompt) + int(rng.integers(0, 9))
            try:
                adm = mgr.admit(prompt, total)
            except kv.PoolExhausted as err:
                log.append(("refused", str(err)))
                continue
            if adm.cow is not None:
                mgr.cow_done(adm.cow[0])
            log.append(("admit", adm.blocks, adm.n_reused, adm.cow,
                        adm.fresh))
            live.append((prompt, adm.blocks))
        elif op < 8:
            prompt, blocks = live.pop(int(rng.integers(0, len(live))))
            gen = [int(t) for t in rng.integers(0, 3, rng.integers(0, 6))]
            written = (prompt + gen)[:len(blocks) * BS]
            mgr.commit(written, blocks)
            mgr.release(blocks)
            log.append(("retire", written))
        else:
            prompt, blocks = live[int(rng.integers(0, len(live)))]
            n_valid = int(rng.integers(0, len(blocks) * BS + 1))
            n_written = int(rng.integers(n_valid, len(blocks) * BS + 1))
            try:
                log.append(("rollback",
                            mgr.rollback(blocks, n_valid, n_written)))
            except ValueError as err:
                log.append(("rollback refused", str(err)))
        log.append(("state", mgr.metrics.as_dict(), mgr.pool.free_count(),
                    mgr.free_tokens(), mgr.occupancy(),
                    mgr.match_len([0, 1, 2, 0, 1, 2, 0])))
        mgr.check_invariants()
    pool = mgr.pool
    log.append(("final", list(pool._free), list(pool._ref),
                sorted(mgr.radix.all_blocks())))
    return log


@pytest.mark.parametrize("seed", range(4))
def test_manager_matches_reference(seed):
    ref = _drive(jkv, seed)
    port = _drive(tkv, seed)
    assert port == ref
    kinds = {entry[0] for entry in ref}
    assert {"admit", "retire", "refused", "rollback"} <= kinds
    counters = [e for e in ref if e[0] == "state"][-1][1]
    assert counters["blocks_evicted"] > 0 and counters["cow_copies"] > 0
