"""Multi-pod dry-run: run every (architecture x input shape) on the
production meshes without allocating anything, and record per-device
flops, collectives and memory (the reference's `repro.launch.dryrun`).

Each case runs as rank 0 of a fake process group as large as the mesh (4,
8, 256 or 512 ranks; torch's "fake" backend, whose collectives move
nothing) under `FakeTensorMode`: params, optimizer state, batches and
caches are fake DTensors laid out by the rule engine's specs
(`launch.shapes.make_case`), and the step runs as it runs on a real mesh:
data parallel over "pod" x "data"; over "model", a train step runs
tensor parallel (`sharding.tp`: each rank its heads, FFN columns or
experts, RG-LRU channels or Mamba2 heads and vocabulary rows, explicit
all-reduces), and so do the serving steps of every family
(`spmd.call_split`: the decode caches hold the sequence over "model",
every rank reads all heads over its slots and the partials are merged;
the prefill caches move from the rank's kv heads to head_dim over
"model" by an all-to-all; a recurrent state stays whole on every rank,
each rank steps its channels or heads and one all-reduce a layer makes
the new state whole).
Counters:

  flops_per_device          FlopCounterMode over the rank's local compute
  collectives               {kind: {count, bytes}} by the reference's five
                            kinds, bytes of each collective's result
                            (CommDebugMode, its dispatch hook extended);
                            the tensor-parallel all-reduces included
  tensor_parallel           whether the step ran tensor parallel;
                            `model_axis_all_reduces` {count, bytes} its
                            operators' all-reduces over "model" (a
                            train step per microbatch: 4 a dense layer,
                            5 an MoE layer, 6 a decoder layer with
                            cross-attention, 1 for the encoder output, 6
                            an RG-LRU layer, 4 a Mamba2 layer, one for
                            the embedding, four for the logits and the
                            loss, two for each leaf stored split and
                            taken whole; remat one more per recomputed
                            mixer output, gather or norm; a decode step:
                            4 a dense or MoE layer, 7 a decoder layer
                            with cross-attention, 4 an RG-LRU layer, 3
                            a Mamba2 layer, one for the embedding and
                            one for the greedy token; a prefill: 2 a
                            dense or MoE layer, 2 an encoder layer, 3 a
                            decoder layer with cross-attention, 4 an
                            RG-LRU layer, 3 a Mamba2 layer, the
                            embedding's and the greedy token's; in
                            serving one for each leaf stored split and
                            taken whole),
                            `gathered_leaves` the leaves stored split over
                            "model" whose compute is gathered
  memory                    MemTracker's peak over the step (the rank's),
                            with the arguments' and outputs' local bytes
  bytes_accessed_per_device null: torch has no per-op bytes-accessed
                            counter (XLA's cost analysis had one)
  corrected_per_device      the raw counts: the reference corrects XLA's
                            scan bodies, counted once; the port's Python
                            layer loop counts every layer

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all                 # single-pod
  python -m repro_torch.launch.dryrun --all --multi-pod     # + (2,16,16)
  python -m repro_torch.launch.dryrun --arch ... --debug-mesh
Outputs one JSON per case under dryrun_results_torch/ (--out). Exits 1 if
any case failed.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from repro_torch.configs import registry
from repro_torch.launch import mesh as M
from repro_torch.launch.shapes import SHAPES, make_case
from repro_torch.sharding import rules as R
from repro_torch.sharding import spmd

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"all_gather": "all-gather", "allgather": "all-gather",
         "all_reduce": "all-reduce", "allreduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "alltoall": "all-to-all"}
DEFAULT_OUT = "dryrun_results_torch"


def _kind(name: str) -> str:
    for k, v in _KIND.items():
        if name.startswith(k):
            return v
    return "other"


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(out)
               if isinstance(t, torch.Tensor))


def comm_counter():
    """A CommDebugMode that also sums the bytes of each collective's
    result, by the reference's kinds (`.collectives`)."""
    from torch.distributed.tensor.debug import CommDebugMode

    class CommCounter(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.collectives = {c: {"count": 0, "bytes": 0}
                                for c in COLLECTIVES}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = sum(self.comm_counts.values())
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented \
                    and sum(self.comm_counts.values()) > before:
                kind = _kind(func._overloadpacket.__name__)
                rec = self.collectives.setdefault(kind,
                                                  {"count": 0, "bytes": 0})
                rec["count"] += 1
                rec["bytes"] += _nbytes(out)
            return out
    return CommCounter()


def fake_group(world: int):
    """Rank 0 of a fresh fake process group of `world` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _place(mesh, tree, specs):
    """Meta leaves of `tree` as fake DTensors laid out by `specs` (a spec
    tree of the same structure); other leaves (the optimizer's host step
    counter) as they are."""
    from torch.distributed.tensor import distribute_tensor
    leaves, tdef = tree_flatten(tree)
    s = iter(R.spec_leaves(specs))
    out = []
    for x in leaves:
        spec = next(s)
        if isinstance(x, torch.Tensor) and x.is_meta:
            full = torch.empty(x.shape, dtype=x.dtype, device="cpu")
            x = distribute_tensor(full, mesh, R.to_placements(mesh, spec),
                                  src_data_rank=None)
        out.append(x)
    return tree_unflatten(out, tdef)


def _local_bytes(tree) -> int:
    return _nbytes([spmd.local(x) for x in tree_leaves(tree)])


def measure_case(cfg, shape_name, mesh, *, microbatches=None, remat=None):
    """Run one case on fake tensors. Returns (case, measurements)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    case = make_case(cfg, shape_name, mesh, microbatches=microbatches,
                     remat=remat)
    kind = SHAPES[shape_name].kind
    if kind != "train" and case["tp"] is None:
        raise ValueError(f"{shape_name}: a serving step runs tensor "
                         "parallel, and the mesh has no 'model' axis "
                         "larger than 1")
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True), \
            R.mesh_context(mesh):
        args = tuple(_place(mesh, a, s) for a, s in
                     zip(case["args"], case["in_specs"]))
        arg_bytes = _local_bytes(args)
        comm = comm_counter()
        flops = FlopCounterMode(display=False)
        mem = MemTracker()
        mem.track_external(*[x for x in tree_leaves(args)
                             if isinstance(x, torch.Tensor)])
        with mem, comm, flops:
            if kind == "train":
                out = case["fn"](*args)
            else:
                with torch.no_grad():
                    out = spmd.call_split(case["fn"], args,
                                          case["out_specs"], case["tp"],
                                          case["local_specs"])
        out_bytes = _local_bytes(out)
        peak = sum(d.get("Total", 0) for d in
                   mem.get_tracker_snapshot("peak").values())
    wall = time.perf_counter() - t0
    colls = {k: dict(v) for k, v in comm.collectives.items()}
    tp = case["tp"]
    return case, {
        "flops": float(flops.get_total_flops()),
        "colls": colls,
        "model_axis_all_reduces": None if tp is None else {
            "count": tp.all_reduces, "bytes": tp.all_reduce_bytes},
        "coll_bytes": int(sum(c["bytes"] for c in colls.values())),
        "memory": {"peak_bytes": int(peak),
                   "argument_size_in_bytes": int(arg_bytes),
                   "output_size_in_bytes": int(out_bytes),
                   "temp_size_in_bytes": int(max(peak - arg_bytes, 0)),
                   "alias_size_in_bytes": None,
                   "generated_code_size_in_bytes": None},
        "run_s": wall}


def run_case(arch_id: str, shape_name: str, mesh, mesh_tag: str, *,
             microbatches=None, remat=None, verbose=True) -> dict:
    cfg = registry.get(arch_id)
    case, m = measure_case(cfg, shape_name, mesh, microbatches=microbatches,
                           remat=remat)
    n_dev = mesh.size()
    meta = {k: v for k, v in case["meta"].items() if k != "cfg"}
    meta["counts"] = ("torch FlopCounterMode / CommDebugMode / MemTracker "
                      "on fake tensors; the layer loop is unrolled, so "
                      "corrected_per_device equals the raw counts")
    rec = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_tag,
        "n_devices": int(n_dev),
        "flops_per_device": m["flops"],
        "bytes_accessed_per_device": None,
        "collectives": m["colls"],
        "collective_bytes_per_device": m["coll_bytes"],
        "tensor_parallel": case["tp"] is not None,
        "model_axis_all_reduces": m["model_axis_all_reduces"],
        "gathered_leaves": case["gathered_leaves"],
        "memory": m["memory"],
        "run_s": round(m["run_s"], 2),
        "meta": meta,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "corrected_per_device": {"flops": m["flops"], "bytes": None,
                                 "coll_bytes": m["coll_bytes"]},
    }
    if verbose:
        print(f"[dryrun] {arch_id:24s} {shape_name:12s} {mesh_tag:10s} "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"coll={rec['collective_bytes_per_device']:.3e}B "
              f"tp={rec['tensor_parallel']} run={m['run_s']:.1f}s")
        print(f"  memory: {m['memory']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=registry.ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="also run the (2,16,16) 512-rank mesh")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="(2,2)/(2,2,2) mesh for fast iteration")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", action="store_true", default=None)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    mk = M.make_debug_mesh if args.debug_mesh else M.make_production_mesh
    pods = []
    if not args.multi_pod_only:
        pods.append((False, "pod1"))
    if args.multi_pod or args.multi_pod_only:
        pods.append((True, "pod2"))

    archs = registry.ARCH_IDS if args.arch is None else [args.arch]
    shapes = sorted(SHAPES) if args.shape is None else [args.shape]
    if not args.all and args.arch is None and args.shape is None:
        ap.error("pass --arch/--shape or --all")

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for multi_pod, tag in pods:
        shape = ((2, 2, 2) if multi_pod else (2, 2)) if args.debug_mesh \
            else ((2, 16, 16) if multi_pod else (16, 16))
        n = 1
        for s in shape:
            n *= s
        fake_group(n)
        mesh = mk(multi_pod=multi_pod, device_type="cpu")
        for arch in archs:
            for shape_name in shapes:
                key = f"{arch}__{shape_name}__{tag}"
                try:
                    rec = run_case(arch, shape_name, mesh, tag,
                                   microbatches=args.microbatches,
                                   remat=args.remat)
                    with open(os.path.join(args.out, key + ".json"),
                              "w") as f:
                        json.dump(rec, f, indent=1)
                except Exception as e:
                    failures.append((key, repr(e)))
                    print(f"[dryrun] FAIL {key}: {e}")
                    traceback.print_exc(limit=5)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"\n[dryrun] done: {len(failures)} failures")
    for k, e in failures:
        print("  FAIL", k, e)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
