"""The port's copy of tests/test_gateway_admission.py, case for case:
repro_torch's tiny-config engines on the CPU (seeded torch weights,
`device="cpu"`). The reference's docstring follows.

Gateway admission control (token budget, 429 stream events) and the
radix-aware prefix-affinity policy over paged replicas."""
import pytest
import torch

from _torch_host import one_torch_thread, shut_down_gateways  # noqa: F401
from repro_torch.configs.base import ModelConfig
from repro_torch.core.queue import TaskQueue
from repro_torch.core.tasks import TaskSpec
from repro_torch.gateway.gateway import Gateway
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

V = 41


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig("t", "dense", 2, 32, 2, 2, 64, V)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    return params, cfg


def _paged_engines(model, n=2, **kw):
    params, cfg = model
    kw.setdefault("batch_slots", 2)
    kw.setdefault("cache_len", 32)
    kw.setdefault("block_size", 4)
    return [ServeEngine(params, cfg, device="cpu", kv_layout="paged", **kw)
            for _ in range(n)]


# -------------------------------------------------------- queue.release

def test_queue_release_returns_task_without_retry_penalty():
    q = TaskQueue()
    spec = TaskSpec.make("s", "serve_lm", {"i": 1}, max_retries=1)
    q.put(spec)
    got = q.get()
    assert got.task_id == spec.task_id
    assert q.release(got.task_id)
    again = q.get()                         # immediately redeliverable
    assert again.task_id == spec.task_id
    # release never consumed a retry: a real nack still gets its full quota
    assert q.nack(spec.task_id) is False    # retry 1 of 1 -> requeued
    assert not q.release("missing")


def test_queue_release_preserves_fifo_position():
    """A capacity-deferred request must not drop behind later-submitted
    peers — release re-queues under the lease's original sequence number,
    so a repeatedly deferred large request cannot be starved by a stream
    of small ones."""
    q = TaskQueue()
    first = TaskSpec.make("s", "serve_lm", {"i": "first"})
    second = TaskSpec.make("s", "serve_lm", {"i": "second"})
    q.put(first)
    q.put(second)
    for _ in range(3):                      # defer repeatedly
        got = q.get()
        assert got.task_id == first.task_id
        q.release(got.task_id)
    assert q.get().task_id == first.task_id


def test_queue_depth_self_corrects_on_acked_republish():
    """Re-publishing an already-acked task id must not wedge depth() above
    zero forever (a consumer loop keyed on depth would spin)."""
    q = TaskQueue()
    spec = TaskSpec.make("s", "serve_lm", {"i": 1})
    q.put(spec)
    q.get()
    q.ack(spec.task_id)
    q.put(spec)                             # identical re-publish
    assert q.get() is None
    assert q.depth() == 0
    assert q.stats()["pending"] == 0


# ---------------------------------------------------- admission control

def test_oversized_request_gets_429_terminal_event(model):
    gw = Gateway(_paged_engines(model), admit_budget=30)
    big = gw.submit(list(range(25)), max_new_tokens=10)      # 35 > 30
    assert big.status == "rejected"
    assert big.stream.finished
    assert big.stream.status_code == 429
    assert big.stream.finish_reason == "over_capacity"
    assert gw.summary()["rejected"] == 1
    # the queue never saw it: nothing to dispatch
    assert gw.queue.depth() == 0


def test_over_replica_capacity_rejected_without_budget(model):
    """Paged replicas can't ring-wrap, so a prompt over their table size is
    un-servable even with admission control off."""
    gw = Gateway(_paged_engines(model))          # cache_len 32, no budget
    big = gw.submit(list(range(30)), max_new_tokens=8)       # 38 > 32
    assert big.status == "rejected" and big.stream.status_code == 429


def test_budget_defers_but_completes_all(model):
    """Committed tokens never exceed the budget, yet everything finishes."""
    gw = Gateway(_paged_engines(model), admit_budget=16)
    reqs = [gw.submit([1, 2, 3], max_new_tokens=5) for _ in range(5)]
    while gw.step() > 0:
        committed = gw._committed_tokens()
        assert committed <= 16, committed
    assert all(r.done for r in reqs)
    assert gw.summary()["completed"] == 5


def test_paged_dispatch_waits_for_free_blocks(model):
    """With a pool too small for two concurrent requests, dispatch holds
    the second in the queue instead of failing it."""
    engines = _paged_engines(model, n=1, batch_slots=2, cache_len=16,
                             pool_blocks=5)     # 4 usable blocks = 16 tok
    gw = Gateway(engines)
    a = gw.submit([1, 2, 3, 4, 5], max_new_tokens=8)     # 13 tok -> 4 blocks
    b = gw.submit([6, 7, 8, 9, 10], max_new_tokens=8)
    done = gw.run()
    assert a.done and b.done and len(done) == 2


def test_unservable_request_rejected_when_capacity_dies(model):
    """Mixed fleet where the only replica big enough fails: the queued
    request must be terminally rejected (429), not lease/released forever
    at the queue head (livelock), and survivors keep serving."""
    params, cfg = model
    dense = ServeEngine(params, cfg, device="cpu",
                        batch_slots=2, cache_len=256)
    paged = ServeEngine(params, cfg, device="cpu", batch_slots=2, cache_len=32,
                        kv_layout="paged", block_size=4)
    gw = Gateway([dense, paged])
    gw.replicas[0].healthy = False
    big = gw.submit(list(range(40)), max_new_tokens=8)   # 48 > paged's 32
    ok = gw.submit([1, 2, 3], max_new_tokens=3)
    gw.run()
    assert big.status == "rejected" and big.stream.status_code == 429
    assert ok.done and len(ok.output) == 3


# ------------------------------------------------ radix-aware affinity

def test_prefix_affinity_follows_cached_bytes(model):
    """Routing consults each replica's radix index: a prompt whose prefix
    is cached on replica 1 goes there even if the hash heuristic would
    pick replica 0."""
    engines = _paged_engines(model, n=2)
    prefix = [5, 6, 7, 8, 9, 10, 11, 12]
    # warm replica 1's cache directly, outside the gateway
    engines[1].submit(prefix + [13], max_new_tokens=2)
    engines[1].run()
    assert engines[1].cached_prefix_tokens(prefix + [20]) >= 8
    gw = Gateway(engines, policy="prefix-affinity")
    r = gw.submit(prefix + [20], max_new_tokens=3)
    gw.run()
    assert r.done and r.replica_id == 1
    kv = gw.kvcache_summary()
    assert kv["hits"] >= 1


def test_prefix_affinity_hash_fallback_on_cold_dense_fleet(model):
    """Dense replicas always probe 0 cached tokens; the policy falls back
    to the deterministic hash so same-prefix traffic still co-locates."""
    params, cfg = model
    engines = [ServeEngine(params, cfg, device="cpu",
                           batch_slots=4, cache_len=32)
               for _ in range(2)]
    gw = Gateway(engines, policy="prefix-affinity")
    # identical within the hashed 8-token prefix, differing after it
    reqs = [gw.submit([9] * 8 + [i], max_new_tokens=2) for i in range(3)]
    gw.run()
    homes = {r.replica_id for r in reqs}
    assert len(homes) == 1                  # all chased the same replica
