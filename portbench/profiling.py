"""One call under ``torch.profiler`` (CPU and CUDA activities), reduced
to plain records the metric readers take: the window (a user annotation
around the call and its synchronize), every device operation and the
host's aten ops and harness spans, all on the profiler's clock."""
from __future__ import annotations

import numpy as np
import torch

SPAN = "portbench.window"


def _kind(name: str) -> str:
    low = name.lower()
    if "memcpy" in low:
        return "memcpy"
    if "memset" in low:
        return "memset"
    return "kernel"


def _raw(prof):
    """``(name, device_type, start_ns, duration_ns)`` of every event,
    from kineto's raw results (no per-event Python objects are built)."""
    for e in prof.profiler.kineto_results.events():
        yield (e.name(), str(e.device_type()), int(e.start_ns()),
               int(e.duration_ns()))


def profiled(fn):
    """``(fn(), record)`` with ``fn`` run under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            result = fn()
            torch.cuda.synchronize()
    device, host, window = [], [], None
    for name, dtype, start, dur in _raw(prof):
        if name == SPAN:
            # the span is recorded on the host and, as an annotation, on
            # the device's timeline; neither is device work
            if not dtype.endswith("CUDA"):
                window = (start, start + dur)
        elif dtype.endswith("CUDA"):
            device.append((name, start, dur, _kind(name)))
        elif name.startswith(("aten::", "portbench.")):
            host.append((name, start, dur))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return result, {"start_ns": window[0], "end_ns": window[1],
                    "device": device, "host": host}


def gap_labels(record: dict, starts, lengths, top: int = 10):
    """The ``top`` longest idle gaps as ``[label, seconds]``, each label
    the host op or harness span running when the gap began (the
    innermost that covers it), or the last one that ended before it."""
    host = record["host"]
    h_start = np.array([h[1] for h in host], np.int64)
    h_end = h_start + np.array([h[2] for h in host], np.int64)
    out = []
    for i in np.argsort(-lengths, kind="stable")[:top]:
        at = starts[i]
        label = "idle"
        if host:
            cover = np.nonzero((h_start <= at) & (h_end > at))[0]
            if cover.size:
                label = host[cover[np.argmax(h_start[cover])]][0]
            else:
                before = np.nonzero(h_end <= at)[0]
                if before.size:
                    label = "after " + host[before[np.argmax(
                        h_end[before])]][0]
        out.append([label, float(lengths[i]) * 1e-9])
    return out


def top_device_ops(record: dict, top: int = 10):
    """The device operations with the most time, ``[name, seconds]``."""
    totals = {}
    for name, _, dur, _ in record["device"]:
        totals[name] = totals.get(name, 0) + dur
    best = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], ns * 1e-9] for name, ns in best]
