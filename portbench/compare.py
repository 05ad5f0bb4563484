"""The comparison that decides ``correct``: every member's outputs from
the timed path against the plain reference's, exactly.

Each compared item is a key of a member's output dict (a per-tick
column, an event row set, a final view, a configuration id). A member's
item that differs in any element is one mismatch; the limit is 0, since
every output is integer or bool and a run that differs in one event is a
different protocol run.
"""
from __future__ import annotations

import numpy as np


def _differs(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape != b.shape or not np.array_equal(a, b)


def outputs(program: list, reference: list) -> list:
    """``[(member, item, detail)]`` for every item that differs."""
    found = []
    if len(program) != len(reference):
        return [(-1, "members", f"{len(program)} != {len(reference)}")]
    for m, (got, want) in enumerate(zip(program, reference)):
        for key in sorted(set(got) | set(want)):
            if key not in got or key not in want:
                found.append((m, key, "missing"))
                continue
            if key == "columns":
                for col in sorted(set(got[key]) | set(want[key])):
                    a = got[key].get(col)
                    b = want[key].get(col)
                    if a is None or b is None or _differs(a, b):
                        found.append((m, f"columns.{col}",
                                      _first_tick(a, b)))
            elif _differs(got[key], want[key]):
                found.append((m, key, "differs"))
    return found


def _first_tick(a, b) -> str:
    if a is None or b is None:
        return "missing"
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return f"shape {a.shape} != {b.shape}"
    t = int(np.nonzero(a != b)[0][0])
    return f"tick {t + 1}: {int(a[t])} != {int(b[t])}"


def summaries(program: list, reference: list) -> list:
    """``[(member, field)]`` where a folded summary differs."""
    if len(program) != len(reference):
        return [(-1, "members")]
    return [(m, key) for m, (got, want) in enumerate(zip(program, reference))
            for key in sorted(set(got) | set(want))
            if got.get(key) != want.get(key)]
