"""The prefills' share of the H100's bf16 peak: the operations the
window's prefills need (the prompt tokens actually computed, after any
reused prefix, causal, with one row of logits; the family's
`prefill_flops`) over their summed `engine.step` spans with
step="prefill" times 989 TFLOP/s, in %."""
from portbench import counts


def read(rec):
    m, fam = rec["model"], rec["family"]
    spans = [(t1 - t0, a) for name, t0, t1, a in rec["spans"]
             if name == "engine.step" and a.get("step") == "prefill"]
    t = sum(d for d, _ in spans)
    if t <= 0:
        return None
    flops = sum(fam.prefill_flops(m, a["reused"],
                                  a["prompt_len"] - a["reused"])
                for _, a in spans)
    return 100.0 * flops / (t * counts.PEAK_BF16_FLOPS)
