"""The decode state updates' share of their bytes bound: the bytes the
covered decode steps' state updates need (each live slot's SSM state and
conv window read once and written once in every Mamba2 layer, and its x,
B, C and dt read once: the family's `state_step_bytes`) over 3.35 TB/s,
against the `mamba.state` region's device time in those steps (the first
decode step of each fused dispatch, whose regions the graph times), in %.
A dispatch's live slots come from the harness's fused taps, matched to
the fused `engine.step` spans in dispatch order."""
from portbench import counts


def read(rec):
    fam = rec["family"]
    if not hasattr(fam, "state_step_bytes"):
        return None
    steps = [a.get("device") or {} for name, _, _, a in rec["spans"]
             if name == "engine.step" and a.get("step") == "fused"]
    if not steps or len(steps) != len(rec["fused"]):
        return None
    per_slot = fam.state_step_bytes(rec["model"])
    need = t = 0.0
    for dev, call in zip(steps, rec["fused"]):
        if "mamba.state" in dev:
            need += len(call["slots"]) * per_slot
            t += dev["mamba.state"] * 1e-3
    if t <= 0 or need <= 0:
        return None
    return 100.0 * need / counts.PEAK_HBM_BYTES_PER_S / t
