"""``contested``: ``{"camps": [lo, hi], "tick": [lo, hi], "delay": [lo,
hi], "coordinator_delay": d}``: at one tick every node proposes removing
the victim of its camp (``lo..hi`` camps, each node's camp and each
camp's victim drawn), with a fallback timer of its own delay; one drawn
node's timer fires first, ``d`` ticks after the proposes, and every
other's at least five ticks later, so one classic round decides."""
from __future__ import annotations

import numpy as np


def draw(spec: dict, n: int, rng) -> dict:
    camps = int(rng.integers(spec["camps"][0], spec["camps"][1] + 1))
    delay = rng.integers(spec["delay"][0], spec["delay"][1] + 1, size=n)
    delay[int(rng.integers(0, n))] = spec["coordinator_delay"]
    if spec["delay"][0] < spec["coordinator_delay"] + 5:
        raise ValueError("contested: every other timer must fire at "
                         "least five ticks after the coordinator's")
    return {"proposes": {
        "tick": int(rng.integers(spec["tick"][0], spec["tick"][1] + 1)),
        "victims": np.sort(rng.choice(n, camps, replace=False)).tolist(),
        "camp": rng.integers(0, camps, size=n), "delay": delay}}
