"""The population plane and `dnn_train` against the reference's, on the
reference's own weights (its `jax.vmap(init_dnn)` / `init_dnn` draws,
bridged with `params_from_jax` and injected in place of the port's draw),
and the port's two planes against each other: member i of a population is
`dnn_train` on its payload. Also the stacked optimizer against the port's
AdamW and SGD run member by member, and the in-graph freeze (the
reference's tests/test_train_integration.py case, and a frozen member's
params and optimizer state held at the step it froze).

The reference's final params are read from its jitted calls (`_Recorder`
stands in for the `jax` module inside `repro.core.population` and
`repro.core.executors`); the port's are the tensors its draw returned,
which training updates in place. Tolerances: the port's stacked products
sum in another order than the reference's, so params within 1e-4 of each
leaf's max |value| and losses within 1e-4 relative; within the port,
population against `dnn_train`, losses within 1e-5 relative.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils._pytree import tree_leaves, tree_map  # noqa: E402

from repro.configs.base import MLPConfig as JMLPConfig  # noqa: E402
from repro.core import executors as JE  # noqa: E402
from repro.core import population as JP  # noqa: E402
from repro.models.dnn import init_dnn as jax_init_dnn  # noqa: E402
from repro_torch.configs.base import MLPConfig  # noqa: E402
from repro_torch.core import executors as TE  # noqa: E402
from repro_torch.core import population as TP  # noqa: E402
from repro_torch.core.tasks import TaskSpec  # noqa: E402
from repro_torch.data import pipeline, synthetic  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402
from repro_torch.optim.stacked import stacked_adamw, stacked_sgd  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from _torch_host import one_torch_thread  # noqa: E402,F401

PARAM_TOL = 1e-4       # of each leaf's max |value|
LOSS_REL = 1e-4        # port against reference
PLANES_REL = 1e-5      # population member against dnn_train, port alone
BLOCKS = [("adam", (1e-2, 3e-3)), ("sgd", (1e-2, 3e-3, 1e12))]


@pytest.fixture(scope="module")
def dataset():
    return pipeline.prepare(synthetic.classification_csv(400, 6, 3, seed=2),
                            "label")


def _block(opt, lrs, epochs=2):
    return [TaskSpec.make("pop", "dnn_train", {
        "hidden_sizes": [16], "activations": ["relu"], "lr": lr,
        "optimizer": opt, "epochs": epochs, "batch_size": 64, "seed": s})
        for s, lr in enumerate(lrs)]


def _jcfg(cfg):
    return JMLPConfig(**dataclasses.asdict(cfg))


class _Recorder:
    """The `jax` module as one reference module sees it, except that every
    function it jits records its arguments and outputs in `calls`."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, *args, **kwargs):
        compiled = jax.jit(fn, *args, **kwargs)

        def call(*a):
            out = compiled(*a)
            self.calls.append((a, out))
            return out
        return call


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_leafwise(port_tree, ref_tree, member=None):
    """Leaf by leaf, by path (the two packages flatten dicts in other
    orders)."""
    assert len(port_tree["layers"]) == len(ref_tree["layers"])
    for lp, lr in zip(port_tree["layers"], ref_tree["layers"]):
        assert set(lp) == set(lr) == {"w", "b"}
        for k in ("w", "b"):
            p, r = lp[k].detach().numpy(), np.asarray(lr[k])
            if member is not None:
                p, r = p[member], r[member]
            assert p.shape == r.shape
            np.testing.assert_allclose(p, r, rtol=0,
                                       atol=PARAM_TOL * np.abs(r).max())


def _same_loss(a, b, rel):
    if np.isfinite(b):
        assert abs(a - b) <= rel * abs(b), (a, b)
    else:
        assert not np.isfinite(a), (a, b)


# ---- the port against the reference, on the reference's weights

@pytest.mark.parametrize("opt,lrs", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_population_matches_reference(opt, lrs, dataset, monkeypatch):
    block = _block(opt, lrs)
    drawn = []

    def reference_draw(seeds, cfg, device):
        keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
        tree = jax.vmap(lambda k: jax_init_dnn(k, _jcfg(cfg)))(keys)
        drawn.append(params_from_jax(_np(tree), cfg, device=device))
        return drawn[-1]
    monkeypatch.setattr(TP, "population_params", reference_draw)
    rec = _Recorder()
    monkeypatch.setattr(JP, "jax", rec)

    ref = JP.train_population(block, {"datasets": {"default": dataset}})
    port = TP.train_population(block, {"datasets": {"default": dataset},
                                       "device": "cpu"})
    ref_params = rec.calls[-1][0][0]          # the stacked evaluation's input
    n_test = dataset.x_test.shape[0]
    assert [d["status"] for d in port] == [d["status"] for d in ref]
    assert [d["error"] for d in port] == [d["error"] for d in ref]
    if opt == "sgd":
        assert [d["status"] for d in port] == ["ok", "ok", "failed"]
    for i, (p, r) in enumerate(zip(port, ref)):
        pm, rm = p["metrics"], r["metrics"]
        assert set(pm) == set(rm)
        assert (pm["n_params"], pm["n_hidden_layers"], pm["population_size"]) \
            == (rm["n_params"], rm["n_hidden_layers"], rm["population_size"])
        _same_loss(pm["final_loss"], rm["final_loss"], LOSS_REL)
        assert abs(pm["accuracy"] - rm["accuracy"]) <= 1 / n_test + 1e-6
        if p["status"] == "ok":
            _close_leafwise(drawn[0], ref_params, member=i)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_dnn_train_matches_reference(opt, dataset, monkeypatch):
    payload = _block(opt, (1e-2,), epochs=3)[0].payload
    drawn = []

    def reference_draw(seed, cfg, device):
        tree = jax_init_dnn(jax.random.PRNGKey(seed), _jcfg(cfg))
        drawn.append(params_from_jax(_np(tree), cfg, device=device))
        return drawn[-1]
    monkeypatch.setattr(TE, "member_params", reference_draw)
    rec = _Recorder()
    monkeypatch.setattr(JE, "jax", rec)

    ref = JE.dnn_train(payload, {"datasets": {"default": dataset}})
    port = TE.dnn_train(payload, {"datasets": {"default": dataset},
                                  "device": "cpu"})
    assert set(port) == set(ref)
    assert (port["n_params"], port["n_hidden_layers"]) == \
        (ref["n_params"], ref["n_hidden_layers"])
    _same_loss(port["final_loss"], ref["final_loss"], LOSS_REL)
    assert abs(port["accuracy"] - ref["accuracy"]) <= \
        1 / dataset.x_test.shape[0] + 1e-6
    _close_leafwise(drawn[0], rec.calls[-1][1][0])   # the last step's params


# ---- the port's two planes against each other

@pytest.mark.parametrize("opt,lrs", [("adam", (1e-2, 3e-3, 3e-2)),
                                     ("sgd", (1e-2, 3e-3, 3e-2))])
def test_population_member_equals_dnn_train(opt, lrs, dataset, monkeypatch):
    """Catches a norm or a learning rate shared across members: the lrs
    differ, and at 3e-2 the clip binds for some steps and not others."""
    ctx = {"datasets": {"default": dataset}, "device": "cpu"}
    block = _block(opt, lrs)
    stacked, single = [], []
    draw_population, draw_member = TP.population_params, TE.member_params
    monkeypatch.setattr(TP, "population_params", lambda *a: stacked.append(
        draw_population(*a)) or stacked[-1])
    monkeypatch.setattr(TE, "member_params", lambda *a: single.append(
        draw_member(*a)) or single[-1])
    docs = TP.train_population(block, ctx)
    for i, t in enumerate(block):
        m = TE.dnn_train(t.payload, ctx)
        _same_loss(docs[i]["metrics"]["final_loss"], m["final_loss"],
                   PLANES_REL)
        assert docs[i]["metrics"]["accuracy"] == pytest.approx(m["accuracy"])
        for p, q in zip(tree_leaves(stacked[0]), tree_leaves(single[i])):
            torch.testing.assert_close(p[i], q, rtol=0,
                                       atol=PARAM_TOL * q.abs().max().item())


def test_member_draw_is_dnn_trains_draw():
    cfg = MLPConfig(n_features=6, n_classes=3, hidden_sizes=(16, 8))
    pop = TP.population_params([4, 0, 9], cfg, "cpu")
    for i, seed in enumerate([4, 0, 9]):
        for p, q in zip(tree_leaves(pop), tree_leaves(
                TE.member_params(seed, cfg, "cpu"))):
            assert torch.equal(p[i], q)


# ---- the in-graph freeze

def test_population_freezes_divergent_member(dataset):
    """In-graph fail-forward: a member driven to divergence (huge lr) is
    frozen and reported failed; its cohort finishes healthy."""
    block = _block("sgd", (1e-2, 1e-2, 1e12))
    docs = TP.train_population(block, {"datasets": {"default": dataset},
                                       "device": "cpu"})
    statuses = [d["status"] for d in docs]
    assert statuses[:2] == ["ok", "ok"]
    assert statuses[2] == "failed"
    assert docs[2]["error"] == "diverged (frozen in-graph)"
    accs = [d["metrics"]["accuracy"] for d in docs[:2]]
    assert all(np.isfinite(a) for a in accs)


def test_frozen_member_keeps_its_state_from_the_step_it_froze(dataset):
    cfg = MLPConfig(n_features=dataset.n_features,
                       n_classes=dataset.n_classes, hidden_sizes=(16,))
    lrs = torch.tensor([1e-2, 1e-2, 1e12])
    params = TP.population_params([0, 1, 2], cfg, "cpu")
    opt_init, opt_update = TP.population_optimizer("sgd", lrs)
    state = opt_init(params)
    step = TP.build_population_step(cfg, opt_update)
    alive = torch.ones(3, dtype=torch.bool)
    data = TE.DeviceData(dataset, 64, 4, "cpu")
    snapshots, alive_log = [], []
    for ep in range(4):
        for batch in data.batches(ep):
            snapshots.append(tree_map(torch.clone, (params, state)))
            params, state, alive, losses = step(params, state, alive, batch)
            alive_log.append(alive.tolist())
    froze = next(s for s, a in enumerate(alive_log) if not a[2])
    assert froze < len(alive_log) - 1, "member 2 froze at the last step"
    assert all(a[:2] == [True, True] for a in alive_log)
    assert not torch.isfinite(losses[2]) or not alive[2]
    at_freeze = snapshots[froze]
    for now, then in zip(tree_leaves((params, state)), tree_leaves(at_freeze)):
        torch.testing.assert_close(now[2], then[2], rtol=0, atol=0)
    assert int(state.step[2]) == froze and int(state.step[0]) == len(alive_log)
    moved = [not torch.equal(a[0], b[0]) for a, b in
             zip(tree_leaves(params), tree_leaves(at_freeze[0]))]
    assert all(moved)


# ---- the stacked optimizer against the port's, member by member

@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_stacked_optimizer_is_the_port_optimizer_per_member(opt):
    lrs = [1e-2, 3e-3, 5e-2]
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen)
    shapes = [(5, 4), (4,), (4, 2), (2,)]
    initial = {"layers": [r(3, *s) for s in shapes]}
    stacked_params = tree_map(torch.clone, initial)
    grads_by_step = []
    for _ in range(4):
        g = [r(3, *s) for s in shapes]
        for x in g:
            x[1] *= 100.0                     # member 1's clip binds
            x[0] *= 0.01                      # member 0's does not
        grads_by_step.append({"layers": g})
    keeps = [[True, True, True], [True, True, False], [True, False, True],
             [True, True, True]]

    t = torch.tensor(lrs)
    init, update = stacked_adamw(t) if opt == "adam" else stacked_sgd(t)
    state = init(stacked_params)
    for g, keep in zip(grads_by_step, keeps):
        stacked_params, state, _ = update(g, state, stacked_params,
                                          torch.tensor(keep))

    for k, lr in enumerate(lrs):
        m_init, m_update = (adamw(lr, weight_decay=0.0) if opt == "adam"
                            else sgd(lr, momentum=0.9))
        params = tree_map(lambda x: x[k].clone(), initial)
        m_state = m_init(params)
        for g, keep in zip(grads_by_step, keeps):
            if keep[k]:
                params, m_state, _ = m_update(
                    tree_map(lambda x: x[k], g), m_state, params)
        for a, b in zip(tree_leaves(params), tree_leaves(stacked_params)):
            torch.testing.assert_close(b[k], a, rtol=1e-6, atol=1e-7)
        assert int(state.step[k]) == int(m_state.step)

