"""Mean `engine.reconcile` span of the fused dispatches (their outputs on
the host through the emits, the clients' token callbacks and the
retirements) over the window, in ms."""


def read(rec):
    d = [t1 - t0 for name, t0, t1, a in rec["spans"]
         if name == "engine.reconcile" and a.get("step") == "fused"]
    return 1e3 * sum(d) / len(d) if d else None
