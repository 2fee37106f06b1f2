"""Mean device time of a fused dispatch's graph replay (`total_ms` of the
fused `engine.step` spans' `device` readings: two events around the
replay on the engine's stream) over the window, in ms."""


def read(rec):
    d = [a["device"]["total_ms"] for name, _, _, a in rec["spans"]
         if name == "engine.step" and a.get("step") == "fused"
         and a.get("device")]
    return sum(d) / len(d) if d else None
