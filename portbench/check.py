"""The comparison that decides `correct`.

Once the window has closed and the program's state is freed, a sample of
the requests it finished, drawn from the seed with the longest among them,
is run through the plain f32 reference (the configuration's family's
`reference_logits`) over each prompt and the tokens served after it. The
number compared is the widest gap by which a served token's reference
logit lies below the reference's best at that position (greedy decoding
serves the best token, so a sound program reads 0 but where rounding
turns a near tie). The control reads the same gap for the token that the
reference computed in float8 puts first.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch


def bucket(n: int, cap: int) -> int:
    """The padded length of an n-token prefill: the next power of two,
    capped at the cache length but never below n (the JAX package's
    bucket rule, which sets an MoE prefill's dispatch group)."""
    b = 1
    while b < n:
        b *= 2
    return max(cap, n) if cap and b > cap else b


def sample(reqs, seed: int, min_tokens: int, max_requests: int) -> List:
    """Finished requests: the longest (most served tokens), then others in
    an order drawn from the seed, until `min_tokens` served tokens or
    `max_requests` requests."""
    done = [r for r in reqs if r.status == "done" and r.tokens]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (len(done[i].tokens), -i))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([seed % 2 ** 64, 29])
    out, n = [done[longest]], len(done[longest].tokens)
    for i in rng.permutation(len(rest)).tolist():
        if n >= min_tokens or len(out) >= max_requests:
            break
        out.append(done[rest[i]])
        n += len(done[rest[i]].tokens)
    return out


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Per position: the reference's best logit less its logit of the
    chosen token."""
    return ref.max(dim=-1).values - ref.gather(1, chosen[:, None])[:, 0]


@torch.no_grad()
def readings(family: ModuleType, w, m: dict, mix: dict, picked,
             control: bool = False) -> Dict[str, Optional[float]]:
    """{"max_logit_gap": program's widest gap, "tokens": served tokens
    compared, "control_gap": the float8 control's (with `control`)}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst, ctrl, n = 0.0, 0.0, 0
    for r in picked:
        ref = family.reference_logits(w, m, mix, r)
        served = torch.as_tensor(r.tokens, device=ref.device)
        worst = max(worst, float(gaps(ref, served).max()))
        n += len(r.tokens)
        if control:
            low = family.reference_logits(w, m, mix, r, quant="fp8")
            ctrl = max(ctrl, float(gaps(ref, low.argmax(dim=-1)).max()))
            del low
        del ref
    out = {"max_logit_gap": worst if picked else None, "tokens": n}
    if control:
        out["control_gap"] = ctrl if picked else None
    return out
