"""The grouped MoE experts kernel's share of its roofline in the profiled
stretch: the bytes of every held expert's three matrices (gate, up, down:
3 x held x d_model x expert_d_ff elements), once per MoE layer per decode
step of the profiled fused replays (each runs all `fused_tokens` steps)
and single steps, over 3.35 TB/s, against the kernel's device time (the
union of its gate/up and down launches' intervals in the trace), in %.
Bound by bytes: a decode step's rows (a few per expert) do a few
operations per weight byte, far below the H100's ridge. Reads nothing
from a program without the kernel or a model without experts."""
from portbench import counts
from portbench.profile import union

KERNEL = "moe_experts_"


def expert_bytes(m: dict) -> int:
    """The held experts' weight bytes of one MoE layer."""
    moe = m["moe"]
    held = moe.get("held_experts") or moe["n_experts"]
    return 3 * held * m["d_model"] * moe["expert_d_ff"] * counts.elt_bytes(m)


def moe_layers(m: dict) -> int:
    """Layers with an MoE FFN: every layer, but the recurrent layers of a
    hybrid whose recurrent layers have no FFN."""
    pattern = m.get("block_pattern")
    if pattern and not m.get("ssm_ffn"):
        return sum(pattern[i % len(pattern)] == "attn"
                   for i in range(m["n_layers"]))
    return m["n_layers"]


def read(rec):
    tr, m = rec["profile"], rec["model"]
    if tr is None or not m.get("moe"):
        return None
    t = sum(b - a for a, b in union((a, b) for n, a, b in tr["ops"]
                                    if KERNEL in n))
    steps = sum(rec["mix"]["fused_tokens"] for c in rec["fused"]
                if c["profiled"])
    steps += sum(1 for c in rec["single"] if c["profiled"])
    need = steps * moe_layers(m) * expert_bytes(m)
    if t <= 0 or need <= 0:
        return None
    return 100.0 * need / counts.PEAK_HBM_BYTES_PER_S / t
