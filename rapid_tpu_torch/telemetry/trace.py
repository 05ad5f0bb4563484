"""Chrome/Perfetto trace-event export for simulation runs.

Own copy of the reference's ``telemetry.trace``: the JSON trace-event
format (``{"traceEvents": [...]}``) that ``ui.perfetto.dev`` and
``chrome://tracing`` load. Two process tracks:

- **pid 1, virtual time**: the run on the virtual-time axis (1 tick =
  ``Settings.tick_ms`` of trace time). Each tick is cut into five
  sub-slices in the shared engine's phase order (decide / deliver /
  flush / churn / monitor), emitted as matched B/E pairs only where the
  phase did work; instants mark proposals, view changes and churn
  activations; counter tracks plot membership, alerts in flight and
  cut-detector fill. A third thread draws the **consensus lineage**: one
  slice per proposal with its phase slices nested inside, and the
  classic 1a/1b/2a/2b slices inside a ``fallback`` slice.
- **pid 2, host wall-clock**: spans recorded by ``wall_span``, on a
  process of their own so the two time axes never mix.

The reference's ``jax_profiler_trace`` wraps a region in JAX's own
tracer; it has no PyTorch form here, and ``rapid_tpu_torch.profile``
(``torch.profiler``) stands in for it.

**Program spans.** ``span(name)`` marks a phase of the program's host
code (the fleet tick and its phases, the reads, the fold, the lowering;
every name starts with ``rapid.``). Spans are off by default, and then a
span is one check of a module flag and a shared null context.
``enable_spans()`` turns them on: each span then stamps its start and
end with ``time.time_ns()`` (the clock ``torch.profiler`` stamps host
events with), appends ``(name, start_ns, end_ns, parent)`` to the
record (``parent`` the index of the enclosing span of the same thread,
-1 for none) and runs inside ``torch.profiler.record_function(name)``,
so a profiler trace shows the phases too. ``take_spans()`` drains the
record; ``disable_spans()`` turns spans off. ``wall_span`` is a span
plus its slice on a ``TraceWriter``'s wall-clock track.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: Whether spans are recorded (``enable_spans``/``disable_spans``).
_spans_on = False
#: The record spans append to while they are on.
_record: Optional["SpanRecord"] = None
#: What ``span`` returns while spans are off.
_NULL_SPAN = nullcontext()


class SpanRecord:
    """The spans recorded while spans are on: ``entries`` is a list of
    ``(name, start_ns, end_ns, parent)``, in the order the spans opened
    (a span still open has ``end_ns`` None). ``parent`` indexes
    ``entries``; each thread nests its own spans."""

    def __init__(self) -> None:
        self.entries: List[Tuple[str, int, Optional[int], int]] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _open(self) -> list:
        """This thread's stack of ``(entries, index)`` of open spans."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Span:
    """One timed region; recorded in ``record`` when that is not None."""

    __slots__ = ("name", "record", "start_ns", "end_ns", "_at", "_rf")

    def __init__(self, name: str, record: Optional[SpanRecord]) -> None:
        self.name = name
        self.record = record

    def __enter__(self) -> "_Span":
        rec = self.record
        if rec is not None:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.time_ns()
        if rec is not None:
            stack = rec._open()
            entries = rec.entries
            parent = (stack[-1][1] if stack and stack[-1][0] is entries
                      else -1)
            with rec._lock:
                index = len(entries)
                entries.append((self.name, self.start_ns, None, parent))
            self._at = (entries, index)
            stack.append(self._at)
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        rec = self.record
        if rec is not None:
            entries, index = self._at
            name, start, _, parent = entries[index]
            entries[index] = (name, start, self.end_ns, parent)
            rec._open().pop()
            self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one phase of the program (module
    docstring): a null context while spans are off."""
    if not _spans_on:
        return _NULL_SPAN
    return _Span(name, _record)


def enable_spans() -> SpanRecord:
    """Turn spans on; returns the record they append to (the one already
    in use when spans are on)."""
    global _spans_on, _record
    if _record is None:
        _record = SpanRecord()
        # A process's first record_function takes about 1.5 ms; paid
        # here, it lies inside no span.
        with torch.profiler.record_function("rapid.spans"):
            pass
    _spans_on = True
    return _record


def disable_spans() -> None:
    """Turn spans off; the record keeps what it holds."""
    global _spans_on
    _spans_on = False


def take_spans() -> List[Tuple[str, int, Optional[int], int]]:
    """The record's entries, leaving it empty. A span open across the
    call completes in the list returned; one opened later under it has
    parent -1."""
    if _record is None:
        return []
    with _record._lock:
        out, _record.entries = _record.entries, []
    return out


VIRTUAL_PID = 1
WALL_PID = 2
TID_PHASES = 1
TID_EVENTS = 2
TID_LINEAGE = 3
TID_WALL = 1

#: Intra-tick phase order of the shared engine (``engine.step``).
PHASES = ("decide", "deliver", "flush", "churn", "monitor")


class TraceWriter:
    """Accumulates trace events; ``write`` emits Perfetto-loadable JSON."""

    def __init__(self) -> None:
        self._events: List[Dict[str, object]] = []
        self._wall_t0_ns = time.time_ns()
        self._meta_done: set = set()

    # -- wall clock ------------------------------------------------------

    def wall_us(self, t_ns: int) -> int:
        """``time.time_ns()`` stamp ``t_ns`` as microseconds since this
        writer was created (wall-clock axis)."""
        return (t_ns - self._wall_t0_ns) // 1000

    # -- metadata --------------------------------------------------------

    def meta_process(self, pid: int, name: str) -> None:
        key = ("process", pid)
        if key in self._meta_done:
            return
        self._meta_done.add(key)
        self._events.append({"ph": "M", "name": "process_name", "pid": pid,
                             "tid": 0, "ts": 0, "args": {"name": name}})

    def meta_thread(self, pid: int, tid: int, name: str) -> None:
        key = ("thread", pid, tid)
        if key in self._meta_done:
            return
        self._meta_done.add(key)
        self._events.append({"ph": "M", "name": "thread_name", "pid": pid,
                             "tid": tid, "ts": 0, "args": {"name": name}})

    # -- events ----------------------------------------------------------

    def slice(self, name: str, ts_us: int, dur_us: int, pid: int, tid: int,
              args: Optional[Dict[str, object]] = None) -> None:
        """A matched B/E pair (duration slice)."""
        begin = {"ph": "B", "name": name, "pid": pid, "tid": tid,
                 "ts": int(ts_us)}
        if args:
            begin["args"] = args
        self._events.append(begin)
        self._events.append({"ph": "E", "pid": pid, "tid": tid,
                             "ts": int(ts_us) + max(1, int(dur_us))})

    def instant(self, name: str, ts_us: int, pid: int, tid: int,
                args: Optional[Dict[str, object]] = None) -> None:
        ev = {"ph": "i", "name": name, "pid": pid, "tid": tid,
              "ts": int(ts_us), "s": "t"}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, name: str, ts_us: int, pid: int,
                values: Dict[str, int]) -> None:
        self._events.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                             "ts": int(ts_us), "args": values})

    # -- output ----------------------------------------------------------

    def sorted_events(self) -> List[Dict[str, object]]:
        """Events sorted by timestamp, emission order breaking ties (so
        same-ts outer B slices stay ahead of their nested children)."""
        return sorted(self._events, key=lambda e: e["ts"])

    def to_json(self) -> Dict[str, object]:
        return {"traceEvents": self.sorted_events(),
                "displayTimeUnit": "ms"}

    def write(self, path) -> None:
        from rapid_tpu_torch.telemetry import write_json_artifact

        write_json_artifact(path, self.to_json())


@contextmanager
def wall_span(writer: Optional[TraceWriter], name: str,
              args: Optional[Dict[str, object]] = None):
    """Time a host-side region onto the wall-clock track: the span
    ``rapid.<name>`` (module docstring) and, with a ``writer``, its
    slice ``name``, timed by the span.

    Without a writer it is the span alone, so instrumented call sites
    cost one flag check un-traced.
    """
    if writer is None:
        with span("rapid." + name):
            yield
        return
    writer.meta_process(WALL_PID, "host wall-clock")
    writer.meta_thread(WALL_PID, TID_WALL, "host")
    s = _Span("rapid." + name, _record if _spans_on else None)
    try:
        with s:
            yield
    finally:
        t0 = writer.wall_us(s.start_ns)
        writer.slice(name, t0, writer.wall_us(s.end_ns) - t0,
                     WALL_PID, TID_WALL, args)


#: ``StepLog`` fields the trace reads, beside the slot counts of the
#: proposal and the decision.
_TRACE_FIELDS = ("tick", "announce_now", "decide_now", "n_member", "epoch",
                 "flushers", "deliver_alive", "probes_sent",
                 "probes_failed", "alerts_in_flight", "cut_reports",
                 "implicit_reports", "vote_tally", "quorum",
                 "churn_injected", "config_hi", "config_lo")


def _host_trace_log(logs):
    """The fields the trace reads, with ``proposal_slots`` and
    ``decision_slots`` (the slot counts of each tick's proposal and
    decision, summed where the log lies), in one transfer."""
    count = lambda x: (x.sum(dim=-1) if torch.is_tensor(x)
                       else np.asarray(x).sum(axis=-1))
    names = _TRACE_FIELDS + ("proposal_slots", "decision_slots")
    cols = {n: getattr(logs, n) for n in _TRACE_FIELDS}
    cols.update(proposal_slots=count(logs.proposal),
                decision_slots=count(logs.decision))
    from rapid_tpu_torch.telemetry.metrics import host_log

    return host_log(SimpleNamespace(_fields=names, **cols))


def trace_from_logs(logs, settings, writer: Optional[TraceWriter] = None,
                    pid: int = VIRTUAL_PID) -> TraceWriter:
    """Render stacked engine ``StepLog`` rows onto the virtual-time axis.

    One tick spans ``settings.tick_ms`` milliseconds of trace time, cut
    into five equal phase sub-slices; a phase is emitted only when it did
    observable work that tick, so quiescent stretches stay empty.
    """
    writer = writer or TraceWriter()
    us_per_tick = settings.tick_ms * 1000
    sub = us_per_tick // len(PHASES)

    host = _host_trace_log(logs)
    ticks = host.tick
    ann = host.announce_now
    dec = host.decide_now
    proposal_slots = host.proposal_slots
    decision_slots = host.decision_slots
    n_member = host.n_member
    epoch = host.epoch
    flushers = host.flushers
    deliver_alive = host.deliver_alive
    probes_sent = host.probes_sent
    probes_failed = host.probes_failed
    in_flight = host.alerts_in_flight
    cut_reports = host.cut_reports
    implicit = host.implicit_reports
    tally = host.vote_tally
    quorum = host.quorum
    churned = host.churn_injected
    cfg_hi = host.config_hi.astype(np.uint64)
    cfg_lo = host.config_lo.astype(np.uint64)
    cfg = (cfg_hi << np.uint64(32)) | cfg_lo

    writer.meta_process(pid, "rapid-tpu virtual time")
    writer.meta_thread(pid, TID_PHASES, "tick phases")
    writer.meta_thread(pid, TID_EVENTS, "protocol events")

    for i in range(len(ticks)):
        t = int(ticks[i])
        base = t * us_per_tick
        phase_work = {
            "decide": bool(dec[i]) or int(tally[i]) > 0,
            "deliver": int(deliver_alive[i]) > 0 or bool(ann[i]),
            "flush": int(flushers[i]) > 0,
            "churn": int(churned[i]) > 0,
            "monitor": int(probes_sent[i]) > 0,
        }
        phase_args = {
            "decide": {"vote_tally": int(tally[i]),
                       "quorum": int(quorum[i]),
                       "epoch": int(epoch[i])},
            "deliver": {"cut_reports": int(cut_reports[i]),
                        "implicit_reports": int(implicit[i])},
            "flush": {"flushers": int(flushers[i])},
            "churn": {"alerts_enqueued": int(churned[i])},
            "monitor": {"probes_sent": int(probes_sent[i]),
                        "probes_failed": int(probes_failed[i])},
        }
        for j, phase in enumerate(PHASES):
            if phase_work[phase]:
                writer.slice(phase, base + j * sub, sub, pid, TID_PHASES,
                             phase_args[phase])
        if ann[i]:
            writer.instant("proposal", base + sub + sub // 2, pid,
                           TID_EVENTS,
                           {"tick": t, "slots": int(proposal_slots[i])})
        if dec[i]:
            writer.instant("view_change", base + sub // 2, pid, TID_EVENTS,
                           {"tick": t, "slots": int(decision_slots[i]),
                            "n_member": int(n_member[i]),
                            "config_id": f"{int(cfg[i]):#x}"})
        if churned[i]:
            writer.instant("churn_activation", base + 3 * sub + sub // 2,
                           pid, TID_EVENTS,
                           {"tick": t, "slots": int(churned[i])})
        writer.counter("membership", base, pid, {"n": int(n_member[i])})
        writer.counter("alerts_in_flight", base, pid,
                       {"batches": int(in_flight[i])})
        writer.counter("cut_reports", base, pid,
                       {"cells": int(cut_reports[i])})
    lineage_trace_from_logs(logs, settings, writer, pid=pid)
    return writer


def lineage_trace_from_logs(logs, settings,
                            writer: Optional[TraceWriter] = None,
                            pid: int = VIRTUAL_PID) -> TraceWriter:
    """Render the lineage span tree of ``StepLog`` rows as nested slices.

    One outer slice per proposal (view-change window), with the phase
    slices laid end-to-end inside it at their folded durations, and the
    classic 1a/1b/2a/2b slices nested inside the ``fallback`` slice of
    the fast round they superseded. Every nested slice carries the
    owning ``proposal``/``epoch`` id in its args, so Perfetto groups the
    chain under its proposal instead of rendering flat phase slices.

    Nested slices are shaved 1–2 us short of their parent's end: the
    trace-event format closes same-``ts`` E events in emission order,
    and the parent's E is emitted first.
    """
    from rapid_tpu_torch.telemetry import lineage as lineage_lib

    writer = writer or TraceWriter()
    us_per_tick = settings.tick_ms * 1000
    from rapid_tpu_torch.telemetry.metrics import host_log

    host = host_log(logs, lineage_lib._ENGINE_FIELDS + ("epoch",))
    ticks = host.tick
    epoch = host.epoch
    spans = lineage_lib.fold_spans(lineage_lib.engine_phase_columns(host))
    if spans:
        writer.meta_process(pid, "rapid-tpu virtual time")
        writer.meta_thread(pid, TID_LINEAGE, "consensus lineage")
    for k, span in enumerate(spans):
        if span["truncated"]:
            continue
        s, d = int(span["window_start"]), int(span["decide_tick"])
        di = np.flatnonzero(ticks == d)
        e = int(epoch[int(di[0])]) if di.size else -1
        own = {"proposal": k, "epoch": e}
        dur = span["durations"]
        writer.slice(f"proposal {k}", (s + 1) * us_per_tick,
                     (d - s) * us_per_tick, pid, TID_LINEAGE,
                     {**own, "fallback": span["fallback"],
                      "durations": dict(dur)})
        cur = (s + 1) * us_per_tick
        fb_ticks = dur["fallback_wait"] + dur["classic_phase_ticks"]
        for name, n_ticks in (("dissemination", dur["dissemination_ticks"]),
                              ("cut_fill", dur["cut_fill_ticks"]),
                              ("fast_round", dur["fast_vote_wait"]),
                              ("fallback", fb_ticks)):
            if n_ticks > 0:
                writer.slice(name, cur, n_ticks * us_per_tick - 1, pid,
                             TID_LINEAGE, own)
            cur += n_ticks * us_per_tick
        if fb_ticks > 0:
            # Classic phases nest inside the fallback slice; its region
            # opens one tick after the resolved fast-round boundary.
            fb_open = d - fb_ticks + 1
            for pname in ("phase1a", "phase1b", "phase2a", "phase2b"):
                m = span["milestones"].get(pname + "_tick")
                if m is not None and fb_open <= m <= d:
                    writer.slice(pname, m * us_per_tick,
                                 us_per_tick - 2, pid, TID_LINEAGE, own)
    return writer
