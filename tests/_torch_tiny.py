"""The reference's serving-test model, ModelConfig("t", "dense", 2, 32, 2,
2, 64, 41), in both packages: the reference's `init_lm` draw, bridged
into the port (`params_from_jax`), so a port engine and a JAX engine serve
the same weights. Imported only by test files that have already done
``pytest.importorskip("jax")``."""
import functools

import jax
import numpy as np

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.params import params_from_jax
from repro_torch.serve.engine import ServeEngine

V = 41
BS = 4


@functools.cache
def tiny(**kw):
    """(jax params, jax cfg, port params, port cfg) for the tiny model
    with config overrides `kw`, built once per process."""
    n_layers = kw.pop("n_layers", 2)
    jcfg = JModelConfig("t", "dense", n_layers, 32, 2, 2, 64, V, **kw)
    tcfg = ModelConfig("t", "dense", n_layers, 32, 2, 2, 64, V, **kw)
    jparams = jax.jit(JT.init_lm, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jparams, jcfg, tparams, tcfg


def port_engine(model, **kw):
    _, _, params, cfg = model
    return ServeEngine(params, cfg, device="cpu", **kw)


_JAX = {}


def jax_engine(model, **kw):
    """One JAX engine per (model, arguments), reset between uses: `reset`
    keeps its jitted steps, so each compiles once per process."""
    key = (id(model[1]), tuple(sorted(kw.items())))
    eng = _JAX.get(key)
    if eng is None:
        jparams, jcfg, _, _ = model
        eng = _JAX[key] = JaxEngine(jparams, jcfg, **kw)
    else:
        eng.reset()
    return eng


def outputs(eng, prompts, max_new=5, sampling=None, **submit):
    reqs = [eng.submit(p, max_new_tokens=max_new, sampling=sampling,
                       **submit) for p in prompts]
    eng.run()
    return [r.output for r in reqs]
