"""Reduce a `torch.profiler` run to what the readers use: the device's
operations as (name, start, end) in seconds, clipped to the traced window
(the harness's `portbench.window` range), the host's labelled ranges, the
busy time (the union of the operations' intervals) and the idle gaps.

The profiler's events are read from its kineto results directly, which
is much cheaper than building its per-op tables."""
from __future__ import annotations

from typing import Dict, List, Tuple

WINDOW_LABEL = "portbench.window"
LABEL_PREFIX = "portbench."


def _annotation(e) -> bool:
    """A host range projected onto the device's timeline, not work."""
    if e.name().startswith(LABEL_PREFIX):
        return True
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def reduce(prof) -> dict:
    """{"window": (a, b), "ops": [(name, a, b)], "labels": [(name, a, b)]},
    times in seconds on the profiler's clock, ops clipped to the window."""
    import torch
    events = prof.profiler.kineto_results.events()
    ops, labels, window = [], [], None
    for e in events:
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not _annotation(e):          # kernels, copies, fills
                ops.append((name, a, b))
        elif name.startswith(LABEL_PREFIX):
            if name == WINDOW_LABEL:
                window = (a, b)
            else:
                labels.append((name[len(LABEL_PREFIX):], a, b))
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW_LABEL} range")
    lo, hi = window
    ops = [(n, max(a, lo), min(b, hi)) for n, a, b in ops if b > lo and a < hi]
    return {"window": window, "ops": sorted(ops, key=lambda o: o[1]),
            "labels": labels}


def union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_s(ops) -> float:
    return sum(b - a for a, b in union((a, b) for _, a, b in ops))


def idle_gaps(trace: dict) -> List[Tuple[float, float]]:
    lo, hi = trace["window"]
    gaps, t = [], lo
    for a, b in union((a, b) for _, a, b in trace["ops"]):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def host_label(labels, t: float) -> str:
    """The innermost (shortest) labelled host range around time t."""
    best = None
    for name, a, b in labels:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "outside the harness's ranges"


def breakdown(trace: dict, top: int = 10) -> Dict[str, list]:
    by_op: Dict[str, float] = {}
    for n, a, b in trace["ops"]:
        by_op[n] = by_op.get(n, 0.0) + (b - a)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[host_label(trace["labels"], (a + b) / 2), b - a]
                          for a, b in gaps]}
