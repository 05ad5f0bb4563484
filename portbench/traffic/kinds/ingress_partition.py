"""``ingress_partition``: ``{"share": s, "start": t, "period": p}``:
``round(s * n)`` distinct nodes receive nothing from any other node from
tick ``t`` on, in the off-phases of a flip-flop of period ``p`` ticks
(``0``: for good); what they send still arrives."""
from __future__ import annotations

import numpy as np

from portbench.traffic.kinds import count

NEVER = 2**31 - 1


def draw(spec: dict, n: int, rng) -> dict:
    cut = np.sort(rng.choice(n, count(spec["share"], n), replace=False))
    rest = np.setdiff1d(np.arange(n), cut)
    return {"windows": [{
        "src": rest.tolist(), "dst": cut.tolist(),
        "start": int(spec["start"]), "end": NEVER,
        "period": int(spec.get("period", 0)), "two_way": False}]}
