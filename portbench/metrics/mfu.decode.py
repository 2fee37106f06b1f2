"""The fused decode's share of the H100's bf16 peak: the operations the
window's fused dispatches need (each live slot's positions in each
dispatch, the family's `decode_flops`: for a decoder the top-k experts
only, attention over the positions written) over the summed `engine.step`
spans with step="fused" times 989 TFLOP/s, in %."""
from portbench import counts


def read(rec):
    m, fam = rec["model"], rec["family"]
    t = sum(t1 - t0 for name, t0, t1, a in rec["spans"]
            if name == "engine.step" and a.get("step") == "fused")
    if t <= 0 or not rec["fused"]:
        return None
    flops = sum(fam.decode_flops(m, range(p, p + n))
                for call in rec["fused"] for p, n in call["slots"])
    return 100.0 * flops / (t * counts.PEAK_BF16_FLOPS)
