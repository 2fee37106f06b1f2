"""Share of the MoE FFN's device time that moves tokens rather than
multiplying them: `moe.route`, `moe.dispatch` and `moe.combine` over all
`moe.*` regions of the window's fused `engine.step` spans' `device`
readings, in %."""

MOVEMENT = ("moe.route", "moe.dispatch", "moe.combine")


def read(rec):
    moved = moe = 0.0
    for name, _, _, a in rec["spans"]:
        d = a.get("device") if name == "engine.step" and \
            a.get("step") == "fused" else None
        if not d:
            continue
        moe += sum(v for k, v in d.items() if k.startswith("moe."))
        moved += sum(d.get(k, 0.0) for k in MOVEMENT)
    return 100.0 * moved / moe if moe > 0 else None
