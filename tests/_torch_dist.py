"""Multi-rank helpers for the port's distribution tests: `spawn` runs a
function on N gloo ranks on the CPU (`torch.multiprocessing`, spawn start
method, one torch thread a rank), rendezvous through a file in the test's
own directory (never a fixed port: the suite runs in several processes at
once), with a timeout for the whole group. The rank functions live here so
the spawned interpreters can import them."""
import os
import pickle
import time

import torch
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 120


def spawn(fn, world: int, tmp_path, *args, timeout=SPAWN_TIMEOUT_S):
    """[fn(rank, world, *args) for every rank], each run in a process of
    its own after `launch.distributed.initialize(..., device="cpu")`."""
    out = tmp_path / f"out_{fn.__name__}_{world}"
    out.mkdir(parents=True, exist_ok=True)
    init = tmp_path / f"init_{fn.__name__}_{world}"
    ctx = mp.start_processes(_entry, args=(fn, world, str(init), str(out),
                                           args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks took "
                                   f"more than {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _entry(rank, fn, world, init, out, args):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch import distributed as D
    D.initialize(f"file://{init}", world, rank, device="cpu")
    try:
        res = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _full(tree):
    from torch.utils._pytree import tree_map
    return tree_map(lambda x: x.full_tensor() if hasattr(x, "full_tensor")
                    else x, tree)


def placements(x):
    """A DTensor's placements as (kind, dim) pairs (their str() differs
    between torch versions)."""
    return [(type(p).__name__, getattr(p, "dim", None))
            for p in x.placements]


# ------------------------------------------------------------ rank functions

def train_ranks(rank, world, ref_params_path, arch, steps, lr, log_every,
                microbatches):
    """The port's train_sharded on make_debug_mesh(multi_pod=True) from the
    reference's initial params (T.init_lm patched), once per microbatch
    count. Returns {mb: (losses, embed local shape, full params)}; the
    params on rank 0 only."""
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import distributed as D
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.params import params_from_jax
    cfg = registry.get(arch, reduced=True)
    with open(ref_params_path, "rb") as f:
        tree = pickle.load(f)["init"]
    D.T.init_lm = lambda gen, c: params_from_jax(tree, c, device="cpu")
    mesh = make_debug_mesh(multi_pod=True, device_type="cpu")
    out = {}
    for mb in microbatches:
        grads = first_grads(cfg, mesh, D, mb)
        stream = TokenStream(cfg.vocab_size, 32, 8, seed=0, branch=4)
        params, opt, losses = D.train_sharded(
            cfg, mesh, iter(stream), num_steps=steps, lr=lr,
            microbatches=mb, log_every=log_every, verbose=False)
        table = params["embed"]["table"]
        moments_ok = all(x.placements == p.placements for x, p in zip(
            torch.utils._pytree.tree_leaves(opt.mu),
            torch.utils._pytree.tree_leaves(params)))
        full = _full(params)
        out[mb] = {"losses": losses,
                   "embed_local": tuple(table.to_local().shape),
                   "embed_global": tuple(table.shape),
                   "embed_placements": placements(table),
                   "moments_like_params": moments_ok,
                   "params": full if rank == 0 else None,
                   "grads": grads if rank == 0 else None}
    return out


def first_grads(cfg, mesh, D, microbatches):
    """The gradients the sharded step hands its optimizer on the stream's
    first batch (full tensors), from `D.T.init_lm`'s params."""
    from repro_torch.data.tokens import TokenStream
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as R
    from repro_torch.train.step import build_lm_train_step
    from torch.utils._pytree import tree_leaves
    params = D.T.init_lm(None, cfg)
    opt_init, _ = adamw(1e-3)
    params, opt, _, _ = D.shard_model(cfg, mesh, params, opt_init(params))
    got = []

    def record(grads, state, p):
        got.extend(x.full_tensor() for x in tree_leaves(grads))
        return p, state, {}
    step = build_lm_train_step(cfg, record, microbatches=microbatches)
    batch = TokenStream(cfg.vocab_size, 32, 8, seed=0, branch=4).next_batch()
    step(params, opt, D.put_batch(mesh, R.batch_specs(cfg, batch, mesh),
                                  batch))
    return got


def population_ranks(rank, world, block, ctx):
    """train_population on a ("data",) mesh of all the ranks. Returns
    (docs, the trained stacked params)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import population as TP
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    drawn = []
    draw = TP.population_params

    def record(*a):
        drawn.append(draw(*a))
        return drawn[-1]
    TP.population_params = record
    docs = TP.train_population(block, ctx, mesh=mesh,
                               population_axes=("data",))
    return docs, drawn[0]


def checkpoint_ranks(rank, world, ckpt_dir, ref_dir, arch):
    """Each rank writes the port's DTensor params, restores them with specs
    and with placements; then restores the reference's file (written by
    one process) onto the mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.checkpoint import checkpoint as C
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.params import jax_layout
    from repro_torch.sharding import rules as R
    cfg = registry.get(arch, reduced=True)
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    specs = R.param_specs(cfg, params, mesh)
    dparams = R.distribute(mesh, params, specs)
    path = C.save_checkpoint(ckpt_dir, 3, {"params": dparams})
    by_spec = C.restore_checkpoint(ckpt_dir, 3, {"params": dparams},
                                   shardings={"params": specs}, mesh=mesh)
    pl_tree = tree_map(lambda x: x.placements, dparams)
    by_pl = C.restore_checkpoint(ckpt_dir, 3, {"params": dparams},
                                 shardings={"params": pl_tree})
    same = []
    for name, got in (("spec", by_spec), ("placements", by_pl)):
        for a, b in zip(tree_leaves(got["params"]), tree_leaves(dparams)):
            same.append((name, a.placements == b.placements,
                         bool(torch.equal(a.to_local(), b.to_local()))))
    like = jax_layout(params, cfg)
    last_dim = tree_map(lambda t: (Shard(t.ndim - 1)
                                   if t.ndim and t.shape[-1] % world == 0
                                   else Replicate(),), like)
    model = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    ref = C.restore_checkpoint(ref_dir, 0, like, shardings=last_dim,
                               mesh=model)
    ref_placements = [placements(x) for x in tree_leaves(ref)]
    ref_full = _full(ref)       # a collective: every rank gathers
    return {"path": os.path.basename(path), "same": same,
            "ref_full": ref_full if rank == 0 else None,
            "ref_placements": ref_placements,
            "process_index": C.process_index()}
