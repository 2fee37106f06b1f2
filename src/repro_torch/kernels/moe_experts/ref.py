"""Plain PyTorch version of the grouped MoE experts: what CPU tensors run,
and what the hand-written kernel (csrc/moe_experts.cu) is held against.

`moe_dispatch_ref` orders the (token, expert) entries by expert, stably,
with the entries of experts not held last: perm[offsets[e] + r] is the
r-th entry of held expert e, offsets[n] the first entry not held and
offsets[n + 1] = N. Fixed shapes, no host synchronisation.

`moe_experts_ref` runs each held expert on its rows (a matrix product per
expert over the rows that chose it, as the kernel's blocks do) and writes
each entry's output in entry order; an entry of an expert not held gets
zeros. It reads the offsets on the host, so it is never captured in a
CUDA graph: the kernel is the only CUDA path.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import ACTIVATIONS


def moe_dispatch_ref(flat_e, first: int, n: int):
    """flat_e: (N,) int expert per entry. Returns (perm (N,) int32, offsets
    (n + 2,) int32)."""
    held = (flat_e >= first) & (flat_e < first + n)
    key = torch.where(held, flat_e - first, n)
    perm = torch.sort(key, stable=True).indices.to(torch.int32)
    counts = (key[:, None] == torch.arange(n + 1, device=flat_e.device)) \
        .sum(0)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return perm, offsets.to(torch.int32)


def moe_experts_ref(x, perm, offsets, w_gate, w_up, w_down, *, top_k: int,
                    act: str):
    """x: (T, d); perm, offsets: `moe_dispatch_ref`'s; w_gate, w_up: (n, d,
    ff); w_down: (n, ff, d). Returns y (N, d) in x's dtype, entry i's row
    the output of its expert on token i // top_k."""
    a = ACTIVATIONS[act]
    N, d = perm.shape[0], x.shape[1]
    y = x.new_zeros((N, d))
    off = offsets.tolist()
    entries = perm.long()
    for e in range(w_gate.shape[0]):
        lo, hi = off[e], off[e + 1]
        if lo == hi:
            continue
        rows = x[entries[lo:hi] // top_k]
        h = a(rows @ w_gate[e]) * (rows @ w_up[e])
        y = y.index_copy(0, entries[lo:hi], h @ w_down[e])
    return y
