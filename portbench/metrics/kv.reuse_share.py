"""Prompt tokens served from cached pages over the prompt tokens admitted
in the window (reused + computed), from the KV manager's counters, in %."""


def read(rec):
    a, b = rec["cache"]["start"], rec["cache"]["end"]
    reused = b["tokens_reused"] - a["tokens_reused"]
    computed = b["tokens_computed"] - a["tokens_computed"]
    if reused + computed <= 0:
        return None
    return 100.0 * reused / (reused + computed)
