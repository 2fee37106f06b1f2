"""Mean `engine.step` span with step="fused" (one dispatch of the fused
decode graph and its reconciliation) over the window, in ms."""


def read(rec):
    d = [t1 - t0 for name, t0, t1, a in rec["spans"]
         if name == "engine.step" and a.get("step") == "fused"]
    return 1e3 * sum(d) / len(d) if d else None
