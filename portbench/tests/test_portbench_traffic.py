"""The traffic generator: deterministic for a seed, inside its clamps,
the same work for every seed, prompts that share nothing unless the mix
shares documents."""
import json
from collections import Counter

import pytest

from _portbench_fixture import ROOT, tiny_mix
from portbench import traffic

MIXES = {p.stem: json.loads(p.read_text())
         for p in sorted((ROOT / "portbench" / "traffic").glob("*.json"))}


def _take(t, n):
    return [t.next() for _ in range(n)]


@pytest.mark.parametrize("name", sorted(MIXES))
def test_same_seed_same_requests(name):
    mix = MIXES[name]
    a = _take(traffic.Traffic(mix, 50000, 2 ** 31 + 5), 40)
    b = _take(traffic.Traffic(mix, 50000, 2 ** 31 + 5), 40)
    c = _take(traffic.Traffic(mix, 50000, 2 ** 31 + 6), 40)
    assert a == b and a != c


@pytest.mark.parametrize("name", sorted(MIXES))
def test_lengths_keep_their_clamps(name):
    mix = MIXES[name]
    reqs = _take(traffic.Traffic(mix, 50000, 3), 3 * mix["sizes_block"])
    out = [n for _, n in reqs]
    assert min(out) >= mix["output"]["min"]
    assert max(out) <= mix["output"]["max"]
    for p, n in reqs:
        assert len(p) + n <= mix["cache_len"]
        sh = mix.get("shared")
        assert len(p) <= (sh["doc"]["max"] + sh["question"]["max"] if sh
                          else mix["prompt"]["max"])
        assert min(p) >= traffic.FIRST_TOKEN and max(p) < 50000
    if "prompt" in mix:
        lens = [len(p) for p, _ in reqs]
        assert min(lens) >= mix["prompt"]["min"]
        assert max(lens) <= mix["prompt"]["max"]


def test_clamped_lognormal_arithmetic():
    import numpy as np
    rng = np.random.default_rng(0)
    draws = [traffic.clamped_lognormal(rng, 100, 2.0, 50, 120)
             for _ in range(500)]
    assert min(draws) == 50 and max(draws) == 120
    rng = np.random.default_rng(1)
    x = float(np.random.default_rng(1).lognormal(np.log(100), 0.1))
    assert traffic.clamped_lognormal(rng, 100, 0.1, 1, 10 ** 6) == round(x)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_every_seed_offers_the_same_work_in_the_same_order(name):
    mix = MIXES[name]
    n = 3 * mix["sizes_block"]

    def sizes(seed):
        t = traffic.Traffic(mix, 50000, seed)
        return [(len(p), m) for p, m in _take(t, n)]
    a, b = sizes(1), sizes(2 ** 31 + 2)
    assert a == b
    block = mix["sizes_block"]
    assert Counter(a[:block]) == Counter(a[block:2 * block])
    assert a[:block] != a[block:2 * block]


def test_prompts_share_no_prefix_unless_documents_are_shared():
    t = traffic.Traffic(tiny_mix(), 512, 9)
    firsts = [p[0] for p, _ in _take(t, 300)]
    assert len(set(firsts)) == len(firsts)
    s = traffic.Traffic(tiny_mix(shared=True), 512, 9)
    docs = s.docs
    assert len(docs) == 3 and len({d[0] for d in docs}) == 3
    for p, _ in _take(s, 30):
        assert any(p[:len(d)] == d for d in docs)
        doc = next(d for d in docs if p[:len(d)] == d)
        q = len(p) - len(doc)
        assert 4 <= q <= 12


def test_prefill_lengths_cover_a_shared_mix_copy_on_write():
    assert traffic.prefill_lengths(tiny_mix()) == (16, 48)
    assert traffic.prefill_lengths(tiny_mix(shared=True)) == (4, 12 + 15)
