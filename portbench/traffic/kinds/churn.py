"""``churn``: ``{"waves": w, "size": s, "start": [lo, hi], "period": p,
"keep": k}``: Rapid's join and graceful leave in alternating waves, one
view change each. Wave ``i`` (``0 .. w - 1``) is enqueued at tick
``start + p * i``, ``start`` drawn in ``lo..hi``; an even wave joins the
next ``s`` dormant slots in slot order (``n, n + 1, ...``), an odd one
removes ``s`` members drawn from the view of that wave, never slot
``k``. Every alert of wave ``i`` expects configuration epoch ``i``, the
count of view changes before it. The description's ``churn`` entry is
``{"join": [[slot, tick, epoch], ...], "leave": [...]}``."""
from __future__ import annotations

import numpy as np


def draw(spec: dict, n: int, rng) -> dict:
    waves, size, period = spec["waves"], spec["size"], spec["period"]
    start = int(rng.integers(spec["start"][0], spec["start"][1] + 1))
    joins = (waves + 1) // 2 * size
    view = np.arange(n + joins) < n
    fresh = n
    join, leave = [], []
    for i in range(waves):
        tick = start + period * i
        if i % 2 == 0:
            slots = np.arange(fresh, fresh + size)
            fresh += size
            view[slots] = True
            join += [[int(s), tick, i] for s in slots]
        else:
            members = np.flatnonzero(view)
            members = members[members != spec["keep"]]
            slots = np.sort(rng.choice(members, size, replace=False))
            view[slots] = False
            leave += [[int(s), tick, i] for s in slots]
    return {"churn": {"join": join, "leave": leave}}
