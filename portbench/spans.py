"""The program's own spans (``rapid_tpu_torch.telemetry.trace``) in a
profiled window, and the readings they give.

``profiled`` is ``profiling.profiled`` with the program's spans: the
record it returns has the same ``start_ns``, ``end_ns``, ``device`` and
``host``, the device list without the copies that ``record_function``
leaves on the CUDA timeline (user annotations, which are not device
work), plus ``spans``, the program's spans recorded in the window
(``(name, start_ns, end_ns, parent)``, ``parent`` an index into the list
or -1), and ``device_span``: for each device operation the index of the
innermost span open on the host when it was launched (-1 for none). A
launch's host time is that of its CUDA runtime call, found by the
operation's correlation id, or else that of the PyTorch op it is linked
to. Spans are stamped with ``time.time_ns()``, the profiler's host
clock, so both lie on one axis.

The readers below take the traced run's record (``run.py``'s ``rec``
with ``profile`` from ``profiled`` and ``setup_spans``, the spans of
set-up) and return ``None`` where the record holds none of their
spans (spans were off, or the cell's path has none).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import profiling
from portbench.metrics import _trace


def _annotation(event) -> bool:
    name = event.name()
    return (event.is_user_annotation() or name == profiling.SPAN
            or name.startswith("rapid."))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profiled(fn):
    """``(fn(), record)`` with ``fn`` run under the profiler (CPU and
    CUDA activities) and the program's spans of the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from rapid_tpu_torch.telemetry.trace import take_spans

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    take_spans()
    _sync()
    with profile(activities=activities) as prof:
        with record_function(profiling.SPAN):
            result = fn()
            _sync()
    return result, record_of(prof.profiler.kineto_results.events(),
                             take_spans())


def record_of(events, spans) -> dict:
    """The record of ``profiled`` from kineto's raw events (objects with
    ``name()``, ``device_type()``, ``start_ns()``, ``duration_ns()``,
    ``is_user_annotation()``, ``correlation_id()`` and
    ``linked_correlation_id()``) and the window's spans."""
    device, launch, host, window = [], [], [], None
    runtime, frontend = {}, {}
    for e in events:
        name, start = e.name(), int(e.start_ns())
        on_device = str(e.device_type()).endswith("CUDA")
        if name == profiling.SPAN and not on_device:
            window = (start, start + int(e.duration_ns()))
        if on_device:
            if not _annotation(e):
                device.append((name, start, int(e.duration_ns()),
                               profiling._kind(name)))
                launch.append((e.correlation_id(), e.linked_correlation_id()))
            continue
        if e.linked_correlation_id() > 0:
            runtime[e.correlation_id()] = start
        else:
            frontend[e.correlation_id()] = start
        if name.startswith(("aten::", "portbench.")) and \
                name != profiling.SPAN:
            host.append((name, start, int(e.duration_ns())))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    at = [runtime.get(c, frontend.get(linked, -1)) for c, linked in launch]
    return {"start_ns": window[0], "end_ns": window[1], "device": device,
            "host": host, "spans": spans, "device_span": innermost(spans, at)}


def innermost(spans, times) -> list:
    """For each host time in ``times``, the index of the innermost span
    of ``spans`` open then (-1 for none, or for a time below 0). The
    spans of one thread nest, so the innermost is the one opened last
    among those open (a span never closed stays open)."""
    end = [float("inf") if s[2] is None else s[2] for s in spans]
    out = [-1] * len(times)
    order = sorted(range(len(spans)), key=lambda i: spans[i][1])
    stack, k = [], 0
    for j in sorted(range(len(times)), key=lambda j: times[j]):
        t = times[j]
        if t < 0:
            continue
        while k < len(order) and spans[order[k]][1] <= t:
            while stack and end[stack[-1]] <= spans[order[k]][1]:
                stack.pop()
            stack.append(order[k])
            k += 1
        while stack and end[stack[-1]] <= t:
            stack.pop()
        if stack:
            out[j] = stack[-1]
    return out


def _under(spans, i: int, name: str) -> bool:
    """Whether span ``i`` is ``name`` or lies inside one."""
    while i >= 0:
        if spans[i][0] == name:
            return True
        i = spans[i][3]
    return False


def _named(spans, name: str) -> list:
    return [i for i, s in enumerate(spans) if s[0] == name]


def idle_by_span(record: dict, top: int = 10) -> list:
    """The window's idle time summed by the innermost program span open
    on the host through it, ``[name, seconds]``, the most first; "none"
    where no span was open. Each idle nanosecond goes to the span the
    host was in at that moment, so a gap that opens as a read returns
    goes to what the host did after the read."""
    spans = record.get("spans") or []
    starts, lengths = _trace.idle_gaps(record)
    # idle(t): the idle time before t, piecewise linear
    edges = np.stack([starts, starts + lengths], axis=1).ravel()
    idle = np.stack([np.cumsum(lengths) - lengths, np.cumsum(lengths)],
                    axis=1).ravel()
    lo, hi = record["start_ns"], record["end_ns"]
    cuts = np.unique(np.clip(np.array(
        [lo, hi] + [t for s in spans for t in s[1:3] if t is not None],
        np.int64), lo, hi))
    owner = innermost(spans, cuts[:-1].tolist())
    ns = np.diff(np.interp(cuts, edges, idle)) if edges.size else \
        np.zeros(len(owner))
    totals = {}
    for i, n in zip(owner, ns.tolist()):
        name = spans[i][0] if i >= 0 else "none"
        totals[name] = totals.get(name, 0) + n
    best = sorted(((k, v) for k, v in totals.items() if v > 0),
                  key=lambda kv: -kv[1])[:top]
    return [[name, n * 1e-9] for name, n in best]


def fleet_host_ms_per_dispatch(rec: dict):
    """Summed ``rapid.fleet.host`` over the profiled window's dispatches
    (``rapid.fleet.dispatch``), ms."""
    spans = rec.get("profile", {}).get("spans") or []
    hosts = _named(spans, "rapid.fleet.host")
    dispatches = _named(spans, "rapid.fleet.dispatch")
    if not hosts or not dispatches:
        return None
    return 1e-6 * sum(spans[i][2] - spans[i][1] for i in hosts) \
        / len(dispatches)


def _tick_reads(spans):
    """``(ticks, read ns inside each tick)`` of the fleet ticks."""
    ticks = _named(spans, "rapid.fleet.tick")
    reads = dict.fromkeys(ticks, 0)
    for i in _named(spans, "rapid.read"):
        j = spans[i][3]
        while j >= 0 and spans[j][0] != "rapid.fleet.tick":
            j = spans[j][3]
        if j >= 0:
            reads[j] += spans[i][2] - spans[i][1]
    return ticks, reads


def read_wait_ms_per_tick(rec: dict):
    """Summed ``rapid.read`` inside ``rapid.fleet.tick`` over the
    window's fleet ticks, ms: the host blocked on the card."""
    spans = rec.get("profile", {}).get("spans") or []
    ticks, reads = _tick_reads(spans)
    if not ticks:
        return None
    return 1e-6 * sum(reads.values()) / len(ticks)


def tick_host_ms_per_tick(rec: dict):
    """``rapid.fleet.tick`` less its ``rapid.read`` children, over the
    window's fleet ticks, ms: the host's cost of issuing one tick."""
    spans = rec.get("profile", {}).get("spans") or []
    ticks, reads = _tick_reads(spans)
    if not ticks:
        return None
    issuing = sum(spans[i][2] - spans[i][1] - reads[i] for i in ticks)
    return 1e-6 * issuing / len(ticks)


def rx_match_busy_pct(rec: dict):
    """Device time of the operations launched under ``rapid.rx.match``
    (their union), over the window's busy time, %."""
    prof = rec.get("profile") or {}
    spans = prof.get("spans") or []
    owner = prof.get("device_span") or []
    if not _named(spans, "rapid.rx.match"):
        return None
    busy = _trace.busy_ns(prof)
    if not busy:
        return None
    lo, hi = prof["start_ns"], prof["end_ns"]
    ev = [e for e, i in zip(prof["device"], owner)
          if i >= 0 and _under(spans, i, "rapid.rx.match")]
    if not ev:
        return 0.0
    starts = np.clip(np.array([e[1] for e in ev], np.int64), lo, hi)
    ends = np.clip(np.array([e[1] + e[2] for e in ev], np.int64), lo, hi)
    s, e = _trace.merged(starts, ends)
    return 100.0 * int((e - s).sum()) / busy


def lower_proposes_ms_per_member(rec: dict):
    """Summed ``rapid.lower.proposes`` of set-up over F, ms."""
    spans = rec.get("setup_spans") or []
    proposes = _named(spans, "rapid.lower.proposes")
    if not proposes or not rec.get("members"):
        return None
    return 1e-6 * sum(spans[i][2] - spans[i][1] for i in proposes) \
        / rec["members"]


#: The readings, by the name a per-layer metric would give each.
READINGS = {f.__name__: f for f in (
    fleet_host_ms_per_dispatch, read_wait_ms_per_tick,
    tick_host_ms_per_tick, rx_match_busy_pct, lower_proposes_ms_per_member)}
