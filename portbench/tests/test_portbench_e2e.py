"""End-to-end arithmetic on hand-made client timelines: a rate over the
whole window, tails over every request (a stall moves them), a request
still waiting counted with its wait so far."""
import numpy as np
import pytest

from _portbench_fixture import ROOT  # noqa: F401  (puts portbench on the path)
from portbench import e2e


def req(submit, times):
    r = e2e.ClientRequest([1], 4, submit)
    r.times = list(times)
    r.tokens = [7] * len(times)
    return r


def test_rate_is_all_tokens_in_the_window_over_all_its_seconds():
    reqs = [req(0.0, [0.5, 1.0, 1.5]), req(0.2, [3.9, 4.1])]
    # tokens at 0.5, 1.0, 1.5, 3.9 lie in [0, 4]; 4.1 does not
    assert e2e.output_tokens_per_s(reqs, 0.0, 4.0) == pytest.approx(1.0)


def test_tpot_is_per_request_over_its_tokens_in_the_window():
    reqs = [req(0.0, [0.1, 0.2, 0.3, 0.4]),        # 100 ms a token
            req(0.0, [0.1, 0.5, 0.9]),             # 400 ms
            req(0.0, [0.1])]                       # one token: not counted
    got = e2e.tpot_p90_ms(reqs, 0.0, 1.0)
    assert got == pytest.approx(np.percentile([100.0, 400.0], 90))


def test_a_stall_in_the_window_moves_the_tails():
    base = [req(0.01 * i, [0.01 * i + 0.05 + 0.02 * k for k in range(10)])
            for i in range(20)]
    stalled = [req(0.01 * i, [0.01 * i + 0.05 + 0.02 * k
                              + (0.5 if k >= 5 else 0.0)
                              for k in range(10)]) for i in range(20)]
    assert e2e.tpot_p90_ms(stalled, 0, 5) > e2e.tpot_p90_ms(base, 0, 5) + 40
    late = [req(0.01 * i, [t + (1.0 if i >= 17 else 0.0) for t in r.times])
            for i, r in enumerate(base)]
    assert e2e.ttft_p90_ms(late, 0, 5) > e2e.ttft_p90_ms(base, 0, 5)


def test_a_request_still_waiting_counts_its_wait_so_far():
    reqs = [req(0.0, [0.1]), req(1.0, [])]          # the second never answered
    got = e2e.ttft_p90_ms(reqs, 0.0, 3.0)
    assert got == pytest.approx(np.percentile([100.0, 2000.0], 90))
    # a first token after the window's end also counts as waiting
    reqs = [req(0.0, [0.1]), req(1.0, [3.5])]
    assert e2e.ttft_p90_ms(reqs, 0.0, 3.0) == pytest.approx(got)


def test_requests_outside_the_window_do_not_count():
    reqs = [req(-1.0, [-0.5]), req(0.5, [0.6, 0.7])]
    assert e2e.ttft_p90_ms(reqs, 0.0, 1.0) == pytest.approx(100.0)
    assert e2e.output_tokens_per_s(reqs, 0.0, 1.0) == pytest.approx(2.0)
    assert e2e.output_tokens_per_s([req(0, [])], 0.0, 1.0) is None
