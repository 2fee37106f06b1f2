"""Share of the prefills' stream time in the attention core (pages
gathered, scores, mask, softmax, weighted sum): the `attn.core` regions
over `total_ms` of the window's prefill `engine.step` spans' `device`
readings, in %. Where the prefill is bound by its launches, the total
holds their gaps too."""


def read(rec):
    core = total = 0.0
    for name, _, _, a in rec["spans"]:
        d = a.get("device") if name == "engine.step" and \
            a.get("step") == "prefill" else None
        if not d:
            continue
        core += d.get("attn.core", 0.0)
        total += d["total_ms"]
    return 100.0 * core / total if total > 0 else None
