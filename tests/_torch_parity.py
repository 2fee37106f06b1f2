"""Shared helpers for the parity tests of the PyTorch port (repro_torch)
against the JAX reference (repro). Imported only by test files that have
already done ``pytest.importorskip("jax")``.

Inputs and weights cross between the two frameworks as numpy arrays: the
weights are the reference's own `init_lm` draws, bridged with
`repro_torch.params.params_from_jax`, never re-initialised.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.models import transformer as JT
from repro_torch.configs import registry as treg
from repro_torch.params import params_from_jax
from _torch_host import one_torch_thread  # noqa: F401  (re-exported)


def configs(arch="qwen3-1.7b"):
    """(reference config, port config), both reduced."""
    return jreg.get(arch, reduced=True), treg.get(arch, reduced=True)


@functools.cache
def bridged_model(arch="qwen3-1.7b", seed=0):
    """(jax cfg, torch cfg, jax params, torch params on the CPU), built once
    per process (the reference's init compiles for seconds). Callers must
    not modify the params."""
    jcfg, tcfg = configs(arch)
    jparams = jax.jit(JT.init_lm, static_argnums=1)(jax.random.PRNGKey(seed),
                                                     jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def assert_config_is_the_references(port, ref):
    """Every field of the reference's config, nested configs included,
    has the reference's value in the port's config, and every field only
    the port has (Granite's settings, `configs.base`) stands at its
    default, so that the port runs the reference's model."""
    _same_or_default(port, dataclasses.asdict(ref), type(port).__name__)


def _same_or_default(port, ref: dict, where: str):
    names = {f.name for f in dataclasses.fields(port)}
    assert set(ref) <= names, f"{where}: the port lacks {set(ref) - names}"
    for f in dataclasses.fields(port):
        v = getattr(port, f.name)
        if f.name not in ref:
            assert v == f.default, \
                f"{where}.{f.name}: port-only field at {v!r}, not its " \
                f"default {f.default!r}"
        elif dataclasses.is_dataclass(v) and isinstance(ref[f.name], dict):
            _same_or_default(v, ref[f.name], f"{where}.{f.name}")
        else:
            assert v == ref[f.name], f"{where}.{f.name}: {v!r} against " \
                f"the reference's {ref[f.name]!r}"


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def jax_pools(cache, n_layers):
    """The reference's paged cache ({"blocks": ({"k","v"} stacked on
    n_blocks,), "tail": ()}) as a per-layer list of (k, v) numpy pools."""
    blk = cache["blocks"][0]
    return [(np.asarray(blk["k"][i]), np.asarray(blk["v"][i]))
            for i in range(n_layers)]


def torch_pools(cache):
    return [(to_np(p["k"]), to_np(p["v"])) for p in cache]


def jax_layer_caches(cache, cfg):
    """The reference's dense cache ({"blocks": tuple over block_pattern of
    leaves stacked on n_blocks, "tail": tuple}) as the port's per-layer
    list of numpy dicts, blocks then tail."""
    n_pat = len(cfg.block_pattern)
    out = []
    for li in range(cfg.n_blocks * n_pat):
        out.append({k: np.asarray(v[li // n_pat])
                    for k, v in cache["blocks"][li % n_pat].items()})
    out += [{k: np.asarray(v) for k, v in c.items()} for c in cache["tail"]]
    return out
