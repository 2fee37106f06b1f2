"""The port's optimizers and schedules: the reference's test_optim.py case
for case on the port, and the port against the reference on identical
gradients.

Parity: the same numpy gradients go to the reference's and the port's
AdamW / SGD for five steps; parameters, moments and the step agree within
1e-6 (float32 updates in another order of operations).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import schedules as jax_schedules  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch.optim import adamw, schedules, sgd  # noqa: E402
from repro_torch.optim.adamw import (AdamWState, clip_by_global_norm,  # noqa: E402
                                     global_norm)
from repro_torch.optim.sgd import SGDState  # noqa: E402


def _quadratic_problem():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}

    def grad(p):
        return {"w": 2 * (p["w"] - target)}
    return params, grad, target


# ---- the reference's cases

def test_adamw_converges():
    params, grad, target = _quadratic_problem()
    init, update = adamw(0.1, weight_decay=0.0)
    state = init(params)
    for _ in range(200):
        params, state, m = update(grad(params), state, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)
    assert float(m["lr"]) == pytest.approx(0.1)


def test_sgd_momentum_converges():
    params, grad, target = _quadratic_problem()
    init, update = sgd(0.05, momentum=0.9)
    state = init(params)
    for _ in range(300):
        params, state, _ = update(grad(params), state, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_weight_decay_shrinks_params():
    params = {"w": torch.ones(4) * 10}
    init, update = adamw(0.1, weight_decay=0.5)
    state = init(params)
    p2, _, _ = update({"w": torch.zeros(4)}, state, params)
    assert float(p2["w"].abs().max()) < 10.0


def test_clip_by_global_norm():
    tree = {"a": torch.ones(4) * 10, "b": torch.ones(9) * 10}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) > 1.0
    # below the threshold: untouched
    small = {"a": torch.ones(4) * 0.01}
    c2, _ = clip_by_global_norm(small, 1.0)
    np.testing.assert_allclose(c2["a"].numpy(), 0.01, rtol=1e-6)


def test_warmup_cosine_schedule():
    fn = schedules.linear_warmup_cosine(1.0, 10, 100)
    assert float(fn(torch.tensor(0))) == 0.0
    assert abs(float(fn(torch.tensor(10))) - 1.0) < 1e-6
    assert float(fn(torch.tensor(5))) == 0.5
    assert float(fn(torch.tensor(100))) <= 0.11
    mid = float(fn(torch.tensor(55)))
    assert 0.1 < mid < 1.0


def test_moments_stay_f32_with_bf16_params():
    params = {"w": torch.ones(3, dtype=torch.bfloat16)}
    init, update = adamw(0.1)
    state = init(params)
    assert state.mu["w"].dtype == torch.float32
    p2, s2, _ = update({"w": torch.ones(3, dtype=torch.bfloat16)}, state,
                       params)
    assert p2["w"].dtype == torch.bfloat16
    assert s2.nu["w"].dtype == torch.float32


# ---- against the reference

def _tree(rng, dtype=np.float32):
    return {"a": {"w": rng.standard_normal((5, 7)).astype(dtype),
                  "b": rng.standard_normal(7).astype(dtype)},
            "layers": [rng.standard_normal((3, 4)).astype(dtype)
                       for _ in range(2)]}


def _torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.tensor(a, dtype=dtype), tree)


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _close(t_tree, j_tree, tol=1e-6):
    for t, j in zip(jax.tree.leaves(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), atol=tol,
                                   rtol=tol)


OPTIMIZERS = {
    "adamw": (lambda m: m.adamw(1e-2)),
    "adamw-no-clip": (lambda m: m.adamw(3e-2, clip_norm=None,
                                        weight_decay=0.0)),
    "adamw-clip-small": (lambda m: m.adamw(1e-2, clip_norm=0.1, b2=0.999)),
    "adamw-warmup-cosine": (lambda m: m.adamw(
        m.schedules.linear_warmup_cosine(1e-2, 2, 5))),
    "sgd": (lambda m: m.sgd(1e-2)),
    "sgd-nesterov": (lambda m: m.sgd(m.schedules.inverse_sqrt(1e-2, 2),
                                     nesterov=True)),
}


class _JaxOptim:
    adamw, sgd, schedules = jax_adamw, jax_sgd, jax_schedules


class _TorchOptim:
    adamw, sgd, schedules = adamw, sgd, schedules


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_five_updates_match_reference(name):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    init, update = OPTIMIZERS[name](_TorchOptim)
    jinit, jupdate = OPTIMIZERS[name](_JaxOptim)
    params, jparams = _torch(p0), _jax(p0)
    state, jstate = init(params), jinit(jparams)
    for g in grads:
        params, state, m = update(_torch(g), state, params)
        jparams, jstate, jm = jupdate(_jax(g), jstate, jparams)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    _close(params, jparams)
    assert type(state).__name__ == type(jstate).__name__
    assert state._fields == jstate._fields
    assert int(state.step) == int(jstate.step) == 5
    for field in state._fields[1:]:
        _close(getattr(state, field), getattr(jstate, field))


def test_bf16_params_update_matches_reference():
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    init, update = adamw(1e-2)
    jinit, jupdate = jax_adamw(1e-2)
    params, jparams = _torch(p0, torch.bfloat16), _jax(p0, jnp.bfloat16)
    state, jstate = init(params), jinit(jparams)
    for g in grads:
        params, state, _ = update(_torch(g, torch.bfloat16), state, params)
        jparams, jstate, _ = jupdate(_jax(g, jnp.bfloat16), jstate, jparams)
    # the same float32 update, rounded to bfloat16 once a step
    _close(params, jparams, tol=1e-2)
    _close(state.mu, jstate.mu, tol=1e-6)


@pytest.mark.parametrize("fn", ["constant", "linear_warmup_cosine",
                                "inverse_sqrt"])
def test_schedules_match_reference(fn):
    args = {"constant": (3e-4,), "linear_warmup_cosine": (3e-4, 10, 100),
            "inverse_sqrt": (3e-4, 10)}[fn]
    ours = getattr(schedules, fn)(*args)
    ref = getattr(jax_schedules, fn)(*args)
    for step in range(0, 130, 3):
        a = float(ours(torch.tensor(step, dtype=torch.int32)))
        b = float(ref(jnp.asarray(step, jnp.int32)))
        assert a == pytest.approx(b, rel=1e-6, abs=1e-12), step


def test_state_field_names_are_the_reference_checkpoint_keys():
    assert AdamWState._fields == ("step", "mu", "nu")
    assert SGDState._fields == ("step", "velocity")


def test_mismatched_state_tree_is_refused():
    params = {"a": torch.zeros(2), "b": torch.zeros(2)}
    init, update = adamw(0.1)
    state = init(params)
    swapped = {"b": torch.zeros(2), "a": torch.zeros(2)}
    with pytest.raises(ValueError, match="structure"):
        update(swapped, state, params)


def test_global_norm_of_a_large_leaf_is_exact_to_float32():
    """A float32 norm of millions of elements drifts on the CPU (1e-2
    relative at 2^22 equal elements); the port accumulates each leaf in
    float64, so the clip sees the card's and the reference's norm."""
    x = torch.full((1 << 22,), 1e-3)
    exact = float(x.double().norm())
    assert float(global_norm({"w": x, "b": torch.ones(3)})) == pytest.approx(
        (exact ** 2 + 3) ** 0.5, rel=1e-6)
    assert global_norm({"w": x}).dtype == torch.float32
