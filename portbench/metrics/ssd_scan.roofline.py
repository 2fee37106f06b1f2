"""The SSD scan kernel's share of its roofline in the profiled stretch:
for the prefills whose `engine.step` spans start inside it (at or after
the first gateway step at or past the window's last `PROFILE_SECONDS`,
where the profiler starts), the larger of the operations their scans
need over 989 TFLOP/s and the bytes over 3.35 TB/s (the family's
`ssd_scan_flops` and `ssd_scan_bytes`: every Mamba2 layer), against the
kernel's device time (the union of its passes' intervals in the trace),
in %."""
from portbench import counts
from portbench.profile import union
from portbench.session import PROFILE_SECONDS

KERNEL = "ssd_scan"


def read(rec):
    tr, fam, m = rec["profile"], rec["family"], rec["model"]
    if tr is None or not hasattr(fam, "ssd_scan_flops"):
        return None
    t = sum(b - a for a, b in union((a, b) for n, a, b in tr["ops"]
                                    if KERNEL in n))
    start = rec["t1"] - min(PROFILE_SECONDS, rec["t1"] - rec["t0"])
    first = min((a for a, _ in rec["gateway_steps"] if a >= start),
                default=None)
    if first is None:
        return None
    bound = sum(max(fam.ssd_scan_flops(m, n) / counts.PEAK_BF16_FLOPS,
                    fam.ssd_scan_bytes(m, n) / counts.PEAK_HBM_BYTES_PER_S)
                for n in (a["prompt_len"] - a["reused"]
                          for name, t0, _, a in rec["spans"]
                          if name == "engine.step"
                          and a.get("step") == "prefill" and t0 >= first))
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
