"""Arithmetic over a profiled window: device intervals, their union and
the idle gaps between them (the program's ``profile_window`` sums kernel
times, an upper bound on one stream; the union counts overlap once)."""
from __future__ import annotations

import numpy as np


def device_intervals(profile: dict, kind=None):
    """``(starts, ends)`` int64 ns of the window's device operations
    (kernels, copies, sets), or of one ``kind`` of them, clipped to the
    window."""
    lo, hi = profile["start_ns"], profile["end_ns"]
    ev = [e for e in profile["device"] if kind is None or e[3] == kind]
    if not ev:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    starts = np.clip(np.array([e[1] for e in ev], np.int64), lo, hi)
    ends = np.clip(np.array([e[1] + e[2] for e in ev], np.int64), lo, hi)
    return starts, ends


def merged(starts, ends):
    """The union of intervals as sorted disjoint ``(starts, ends)``."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.nonzero(new)[0]
    last = np.r_[first[1:], s.size] - 1
    return s[first], reach[last]


def busy_ns(profile: dict) -> int:
    s, e = merged(*device_intervals(profile))
    return int((e - s).sum())


def idle_gaps(profile: dict):
    """``(starts, lengths)`` ns of the window's stretches with nothing on
    the device, the head and tail of the window included."""
    s, e = merged(*device_intervals(profile))
    lo, hi = profile["start_ns"], profile["end_ns"]
    g_start = np.r_[lo, e]
    g_end = np.r_[s, hi]
    keep = g_end > g_start
    return g_start[keep], (g_end - g_start)[keep]
