"""Share of the window the gateway's own host work takes: the wall time
inside the harness's calls of `Gateway.step`, less the program's
`engine.step` spans within them, over the window, in %."""


def read(rec):
    steps = rec["gateway_steps"]
    if not steps:
        return None
    inside = sum(b - a for a, b in steps)
    engine = sum(t1 - t0 for name, t0, t1, _ in rec["spans"]
                 if name == "engine.step")
    return 100.0 * (inside - engine) / rec["window_s"]
