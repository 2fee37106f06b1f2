"""Share of the profiled stretch in which no operation ran on the device
(kernels, copies and fills; the union of their intervals), in %."""
from portbench.profile import busy_s


def read(rec):
    tr = rec["profile"]
    if tr is None or not tr["ops"]:
        return None
    a, b = tr["window"]
    return 100.0 * (1.0 - busy_s(tr["ops"]) / (b - a))
