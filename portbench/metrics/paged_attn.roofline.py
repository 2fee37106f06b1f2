"""The paged-attention kernel's share of its roofline in the profiled
stretch: the bytes its decode reads need (each live slot's K/V up to its
position once, q and the output, its block ids; every paged-attention
layer; the family's `paged_read_bytes`) over 3.35 TB/s, against the
kernel's device time (the union of its two passes' intervals in the
trace), in %. Bound
by bytes: the read does 4 * head_dim operations per K/V pair of 2 *
head_dim * 2 bytes, far below the H100's ridge."""
from portbench import counts
from portbench.profile import union

KERNEL = "paged_attention"


def read(rec):
    tr = rec["profile"]
    if tr is None:
        return None
    spans = union((a, b) for n, a, b in tr["ops"] if KERNEL in n)
    t = sum(b - a for a, b in spans)
    m, bs = rec["model"], rec["mix"]["block_size"]
    fam = rec["family"]
    calls = [c for c in rec["fused"] + rec["single"] if c["profiled"]]
    need = sum(fam.paged_read_bytes(m, p + j, bs)
               for c in calls for p, n in c["slots"] for j in range(n))
    if t <= 0 or need <= 0:
        return None
    return 100.0 * need / counts.PEAK_HBM_BYTES_PER_S / t
