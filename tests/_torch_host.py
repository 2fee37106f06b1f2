"""Fixtures for the port's tests that need no JAX (the gateway and its
host-side stack on the port's own tiny-config engines)."""
import pytest
import torch

from repro_torch.gateway.gateway import Gateway


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port tests' tensors are tiny, and the suite runs in several
    worker processes at once: torch's default of one intra-op thread per
    core only oversubscribes the machine. Import this fixture into a test
    module to run its torch ops on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def shut_down_gateways(monkeypatch):
    """Every Gateway a test constructs is shut down after the test, failed
    or not: its replica worker threads and its sampler thread are stopped
    and joined with a timeout, so a stuck worker fails one test instead of
    hanging the suite. Yields the list of gateways made so far."""
    made = []
    init = Gateway.__init__

    def tracked(self, *args, **kwargs):
        made.append(self)
        init(self, *args, **kwargs)
    monkeypatch.setattr(Gateway, "__init__", tracked)
    yield made
    for gw in made:
        gw.shutdown()
