"""``crash``: ``{"share": s, "tick": t}``: ``round(s * n)`` distinct
nodes fail-stop at tick ``t``."""
from __future__ import annotations

import numpy as np

from portbench.traffic.kinds import count


def draw(spec: dict, n: int, rng) -> dict:
    slots = np.sort(rng.choice(n, count(spec["share"], n), replace=False))
    return {"crashes": [[int(s), int(spec["tick"])] for s in slots]}
