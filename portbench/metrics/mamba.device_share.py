"""Share of the fused decode's device time that the Mamba2 mixers take:
the `mamba.*` regions (projections and conv, the state step, the gated
norm and out_proj) over the covered time (`covered_ms`: the first decode
step of each dispatch, whose regions the fused graph times) of the
window's fused `engine.step` spans' `device` readings, in %."""


def read(rec):
    mamba = covered = 0.0
    found = False
    for name, _, _, a in rec["spans"]:
        d = a.get("device") if name == "engine.step" and \
            a.get("step") == "fused" else None
        if not d:
            continue
        part = [v for k, v in d.items() if k.startswith("mamba.")]
        found = found or bool(part)
        mamba += sum(part)
        covered += d.get("covered_ms", d["total_ms"])
    return 100.0 * mamba / covered if found and covered > 0 else None
