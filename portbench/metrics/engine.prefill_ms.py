"""Mean `engine.step` span with step="prefill" over the window, in ms
(the span ends after the first token reaches the host)."""


def read(rec):
    d = [t1 - t0 for name, t0, t1, a in rec["spans"]
         if name == "engine.step" and a.get("step") == "prefill"]
    return 1e3 * sum(d) / len(d) if d else None
