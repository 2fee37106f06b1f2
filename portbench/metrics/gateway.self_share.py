"""Share of the window the gateway's own host work takes, from the
program's spans alone: each `gateway.step` span less the `engine.step`
spans inside it, summed, over the window, in %."""


def read(rec):
    gw = sorted((t0, t1) for name, t0, t1, _ in rec["spans"]
                if name == "gateway.step")
    if not gw:
        return None
    eng = sorted((t0, t1) for name, t0, t1, _ in rec["spans"]
                 if name == "engine.step")
    own, i = 0.0, 0
    for a, b in gw:
        own += b - a
        while i < len(eng) and eng[i][0] < a:
            i += 1
        while i < len(eng) and eng[i][1] <= b:
            own -= eng[i][1] - eng[i][0]
            i += 1
    return 100.0 * own / rec["window_s"]
