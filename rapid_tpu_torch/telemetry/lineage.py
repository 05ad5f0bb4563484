"""Consensus lineage: phase-attributed view-change spans.

Own copy of the reference's ``telemetry.lineage``. Rapid's membership
pipeline runs alert dissemination, cut-detector fill, the fast-quorum
vote and, when that loses, the classic-Paxos fallback; this module folds
a run's per-tick phase streams into one **span** per view change: the
first tick of every phase, the phase durations, and in per-receiver runs
the critical straggler edge with the ``DelayRule`` behind it.

Every source of per-tick phase activity has an adapter giving the same
:class:`PhaseColumns`, so one fold serves them all:

- :func:`engine_phase_columns`: the shared engine's ``StepLog`` factors,
  multiplied as ``engine.diff`` multiplies them;
- :func:`receiver_phase_columns`: one per-receiver member's
  ``ReceiverStepLog`` counters;
- :func:`counter_phase_columns`: host counter dict streams and a view
  event stream;
- :func:`gauge_phase_columns`: ``TickMetrics`` gauge rows;
- :func:`ring_phase_columns`: a flight recorder's ``[W, G]`` gauge ring
  (no per-phase columns: classic-phase boundaries are marked
  unobservable, never guessed).

The adapters read the log fields they need to the host in one transfer
(``metrics.host_log``); :func:`fold_spans` is host numpy over the
columns. For every span that is not truncated::

    dissemination_ticks + cut_fill_ticks + fast_vote_wait
        + fallback_wait + classic_phase_ticks == ticks_to_view_change

Milestones that did not occur resolve to the next observed boundary, so
the sum closes without inventing ticks.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rapid_tpu_torch.faults import delay_of_slots
from rapid_tpu_torch.telemetry.metrics import host_log

#: Span duration fields, in pipeline order.
LINEAGE_DURATIONS = (
    "dissemination_ticks",
    "cut_fill_ticks",
    "fast_vote_wait",
    "fallback_wait",
    "classic_phase_ticks",
)

#: Phase boundary milestones recorded per span (``None`` = not observed).
LINEAGE_MILESTONES = (
    "first_alert_tick",
    "first_report_tick",
    "announce_tick",
    "first_vote_tick",
    "fallback_armed_tick",
    "phase1a_tick",
    "phase1b_tick",
    "phase2a_tick",
    "phase2b_tick",
)

#: Milestones that only the engine can observe (timer gauges); dropped by
#: :func:`comparable` so oracle/engine span streams diff clean.
_ENGINE_ONLY_MILESTONES = ("fallback_armed_tick",)


# ---------------------------------------------------------------------------
# Phase columns
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PhaseColumns:
    """Per-tick phase activity columns (numpy, ``[T]`` or ``[F, T]``).

    ``phase*_sent`` columns are ``None`` when the source stream cannot
    observe classic-phase traffic (flight-recorder rings); the fold then
    refuses to place classic-phase boundaries instead of guessing.
    ``timers_armed`` is engine-only (``None`` on oracle streams).
    """

    tick: np.ndarray
    alert_sent: np.ndarray
    alert_delivered: np.ndarray
    fast_vote_sent: np.ndarray
    phase1a_sent: Optional[np.ndarray]
    phase1b_sent: Optional[np.ndarray]
    phase2a_sent: Optional[np.ndarray]
    phase2b_sent: Optional[np.ndarray]
    announce: np.ndarray
    decide: np.ndarray
    timers_armed: Optional[np.ndarray] = None

    @property
    def phases_observed(self) -> bool:
        return self.phase1a_sent is not None

    def member(self, j: int) -> "PhaseColumns":
        """Row ``j`` of ``[F, T]``-shaped columns as a ``[T]`` view."""
        vals = {}
        for f in fields(self):
            v = getattr(self, f.name)
            vals[f.name] = None if v is None else np.asarray(v)[j]
        return PhaseColumns(**vals)


def _i64(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


#: ``StepLog`` fields ``engine_phase_columns`` reads.
_ENGINE_FIELDS = ("tick", "vote_senders", "vote_recipients",
                  "pxvote_senders", "pxvote_recipients", "flushers",
                  "flush_recipients", "flushers_alive", "deliver_alive",
                  "px1a_senders", "px1a_recipients", "px1b_senders",
                  "px2a_senders", "px2a_recipients", "px2b_senders",
                  "px2b_recipients", "announce_now", "decide_now",
                  "px_timers_armed")

#: ``ReceiverStepLog`` fields ``receiver_phase_columns`` reads.
_RECEIVER_FIELDS = ("tick", "sent", "delivered", "fv_sent", "p1a_sent",
                    "p1b_sent", "p2a_sent", "p2b_sent", "fv_delivered",
                    "p1a_delivered", "p1b_delivered", "p2a_delivered",
                    "p2b_delivered", "announce", "decide")


def engine_phase_columns(logs) -> PhaseColumns:
    """Columns from the shared engine's ``StepLog`` factor logs (``[T]`` or
    ``[F, T]``), expanding the same sender x recipient products as the
    counter differential in ``engine.diff``."""
    logs = host_log(logs, _ENGINE_FIELDS)
    fast_vote = (_i64(logs.vote_senders) * _i64(logs.vote_recipients)
                 + _i64(logs.pxvote_senders) * _i64(logs.pxvote_recipients))
    return PhaseColumns(
        tick=_i64(logs.tick),
        alert_sent=_i64(logs.flushers) * _i64(logs.flush_recipients),
        alert_delivered=_i64(logs.flushers_alive) * _i64(logs.deliver_alive),
        fast_vote_sent=fast_vote,
        phase1a_sent=_i64(logs.px1a_senders) * _i64(logs.px1a_recipients),
        phase1b_sent=_i64(logs.px1b_senders),
        phase2a_sent=_i64(logs.px2a_senders) * _i64(logs.px2a_recipients),
        phase2b_sent=_i64(logs.px2b_senders) * _i64(logs.px2b_recipients),
        announce=np.asarray(logs.announce_now).astype(bool),
        decide=np.asarray(logs.decide_now).astype(bool),
        timers_armed=_i64(logs.px_timers_armed),
    )


def receiver_phase_columns(mlog) -> PhaseColumns:
    """Columns from one member's ``ReceiverStepLog`` exact counters.

    The per-receiver engine counts per-phase traffic directly; alert traffic
    is the remainder of the total over the consensus classes.
    """
    mlog = host_log(mlog, _RECEIVER_FIELDS)
    fv = _i64(mlog.fv_sent)
    p1a, p1b = _i64(mlog.p1a_sent), _i64(mlog.p1b_sent)
    p2a, p2b = _i64(mlog.p2a_sent), _i64(mlog.p2b_sent)
    phase_sent = fv + p1a + p1b + p2a + p2b
    phase_delivered = (_i64(mlog.fv_delivered) + _i64(mlog.p1a_delivered)
                       + _i64(mlog.p1b_delivered) + _i64(mlog.p2a_delivered)
                       + _i64(mlog.p2b_delivered))
    return PhaseColumns(
        tick=_i64(mlog.tick),
        alert_sent=_i64(mlog.sent) - phase_sent,
        alert_delivered=_i64(mlog.delivered) - phase_delivered,
        fast_vote_sent=fv,
        phase1a_sent=p1a,
        phase1b_sent=p1b,
        phase2a_sent=p2a,
        phase2b_sent=p2b,
        announce=np.asarray(mlog.announce).astype(bool).any(axis=-1),
        decide=np.asarray(mlog.decide).astype(bool).any(axis=-1),
        timers_armed=None,
    )


_PHASE_KEYS = ("fast_vote", "phase1a", "phase1b", "phase2a", "phase2b")


def _event_tick_kind(ev) -> Tuple[int, str]:
    if hasattr(ev, "tick"):
        return int(ev.tick), str(ev.kind)
    return int(ev[0]), str(ev[1])


def counter_phase_columns(tick_history: Sequence[Dict[str, int]],
                          phase_history: Sequence[Dict[str, int]],
                          events, start_tick: int = 0) -> PhaseColumns:
    """Columns from host-oracle (or adversary-referee) counter streams.

    ``tick_history[i]`` / ``phase_history[i]`` describe tick
    ``start_tick + 1 + i``; ``events`` is a view-event stream (objects
    with ``.tick``/``.kind`` or ``(tick, kind, ...)`` tuples) supplying
    the announce/decide flags.
    """
    t = len(tick_history)
    ticks = start_tick + 1 + np.arange(t, dtype=np.int64)
    sent = np.array([d.get("sent", 0) for d in tick_history], np.int64)
    delivered = np.array([d.get("delivered", 0) for d in tick_history],
                         np.int64)
    phase = {}
    for key in _PHASE_KEYS:
        phase[key + "_sent"] = np.array(
            [phase_history[i].get(key + "_sent", 0) if i < len(phase_history)
             else 0 for i in range(t)], np.int64)
        phase[key + "_delivered"] = np.array(
            [phase_history[i].get(key + "_delivered", 0)
             if i < len(phase_history) else 0 for i in range(t)], np.int64)
    phase_sent = sum(phase[k + "_sent"] for k in _PHASE_KEYS)
    phase_delivered = sum(phase[k + "_delivered"] for k in _PHASE_KEYS)
    announce = np.zeros(t, bool)
    decide = np.zeros(t, bool)
    for ev in events:
        tick, kind = _event_tick_kind(ev)
        i = tick - start_tick - 1
        if 0 <= i < t:
            if kind == "proposal":
                announce[i] = True
            elif kind == "view_change":
                decide[i] = True
    return PhaseColumns(
        tick=ticks,
        alert_sent=sent - phase_sent,
        alert_delivered=delivered - phase_delivered,
        fast_vote_sent=phase["fast_vote_sent"],
        phase1a_sent=phase["phase1a_sent"],
        phase1b_sent=phase["phase1b_sent"],
        phase2a_sent=phase["phase2a_sent"],
        phase2b_sent=phase["phase2b_sent"],
        announce=announce,
        decide=decide,
        timers_armed=None,
    )


def _gauge(v: int) -> int:
    # UNOBSERVED gauges are -1; clamp so activity tests stay boolean-clean.
    return max(int(v), 0)


def gauge_phase_columns(rows) -> PhaseColumns:
    """Columns from ``TickMetrics`` gauge rows (streaming service path).

    Gauges are occupancy/level signals rather than exact message counts,
    but first-positive ticks coincide with the phase boundaries, which
    is all the fold consumes.
    """
    return PhaseColumns(
        tick=np.array([r.tick for r in rows], np.int64),
        alert_sent=np.array([_gauge(r.alerts_in_flight) for r in rows],
                            np.int64),
        alert_delivered=np.array(
            [_gauge(r.cut_reports) + _gauge(r.implicit_reports)
             for r in rows], np.int64),
        fast_vote_sent=np.array(
            [_gauge(r.vote_tally) + _gauge(r.px_fast_vote_sent)
             for r in rows], np.int64),
        phase1a_sent=np.array([_gauge(r.px_phase1a_sent) for r in rows],
                              np.int64),
        phase1b_sent=np.array([_gauge(r.px_phase1b_sent) for r in rows],
                              np.int64),
        phase2a_sent=np.array([_gauge(r.px_phase2a_sent) for r in rows],
                              np.int64),
        phase2b_sent=np.array([_gauge(r.px_phase2b_sent) for r in rows],
                              np.int64),
        announce=np.array([bool(r.announce) for r in rows], bool),
        decide=np.array([bool(r.decide) for r in rows], bool),
        timers_armed=np.array([_gauge(r.px_timers_armed) for r in rows],
                              np.int64),
    )


def ring_phase_columns(payload: Dict[str, object]) -> PhaseColumns:
    """Columns from a flight-recorder payload's ``[W, G]`` gauge ring.

    The ring records no per-phase ``px_*`` columns, so classic-phase
    boundaries are unobservable (``phase*_sent`` are ``None``); the fold
    degrades those spans honestly instead of inventing boundaries.
    """
    names = list(payload["gauges"])
    rows = np.asarray(payload["rows"], np.int64)
    col = {name: rows[:, i] for i, name in enumerate(names)}
    clip = lambda a: np.maximum(a, 0)
    return PhaseColumns(
        tick=col["tick"],
        alert_sent=clip(col["alerts_in_flight"]),
        alert_delivered=clip(col["cut_reports"]),
        fast_vote_sent=clip(col["vote_tally"]),
        phase1a_sent=None,
        phase1b_sent=None,
        phase2a_sent=None,
        phase2b_sent=None,
        announce=col["announces"] > 0,
        decide=col["decides"] > 0,
        timers_armed=clip(col["px_timers_armed"]),
    )


# ---------------------------------------------------------------------------
# Span fold
# ---------------------------------------------------------------------------


def _blank_milestones() -> Dict[str, Optional[int]]:
    return {name: None for name in LINEAGE_MILESTONES}


def _blank_durations() -> Dict[str, Optional[int]]:
    return {name: None for name in LINEAGE_DURATIONS}


def _resolve_durations(window_start: int, ms: Dict[str, Optional[int]],
                       decide_tick: int, phases_observed: bool,
                       fallback: bool) -> Dict[str, int]:
    """Telescoping phase durations; always sums to ``decide - start``.

    Missing boundaries resolve to the next observed one, and each is
    clamped monotone into ``[window_start, decide_tick]`` so a late
    first-seen (e.g. a re-flush) can never drive a duration negative.
    """
    s, d = window_start, decide_tick
    a = ms["announce_tick"]
    if a is None:
        a = ms["first_vote_tick"]
    f = ms["phase1a_tick"] if phases_observed else None
    if f is None:
        f = d
    if a is None:
        a = f
    r = ms["first_report_tick"]
    if r is None:
        r = a
    r = min(max(r, s), d)
    a = min(max(a, r), d)
    f = min(max(f, a), d)
    out = {
        "dissemination_ticks": r - s,
        "cut_fill_ticks": a - r,
        "fast_vote_wait": 0 if fallback else d - a,
        "fallback_wait": f - a if fallback else 0,
        "classic_phase_ticks": d - f,
    }
    if fallback and not phases_observed:
        # Ring streams cannot see the 1a boundary: the classic share is
        # folded into fallback_wait (f == d above), keeping the sum exact.
        out["classic_phase_ticks"] = 0
    return out


def _make_span(window_start: Optional[int], ms: Dict[str, Optional[int]],
               decide_tick: int, phases_observed: bool,
               truncated: bool = False) -> Dict[str, object]:
    if truncated:
        return {
            "window_start": None,
            "decide_tick": int(decide_tick),
            "ticks_to_view_change": None,
            "fallback": False,
            "truncated": True,
            "milestones": _blank_milestones(),
            "durations": _blank_durations(),
            "critical_path": None,
        }
    assert window_start is not None
    if phases_observed:
        fallback = ms["phase1a_tick"] is not None
    else:
        fallback = ms["fallback_armed_tick"] is not None
    return {
        "window_start": int(window_start),
        "decide_tick": int(decide_tick),
        "ticks_to_view_change": int(decide_tick - window_start),
        "fallback": bool(fallback),
        "truncated": False,
        "milestones": dict(ms),
        "durations": _resolve_durations(window_start, ms, decide_tick,
                                        phases_observed, fallback),
        "critical_path": None,
    }


def _first_positive(arr: Optional[np.ndarray], sl: slice,
                    ticks: np.ndarray) -> Optional[int]:
    if arr is None:
        return None
    seg = np.asarray(arr[sl])
    nz = np.flatnonzero(seg > 0)
    if nz.size == 0:
        return None
    return int(ticks[sl][nz[0]])


def fold_spans(cols: PhaseColumns, *, start_tick: Optional[int] = None,
               truncated_head: bool = False) -> List[Dict[str, object]]:
    """Fold per-tick phase columns into per-view-change span records.

    Windows run ``(previous decide, decide]``; the first window opens at
    ``start_tick`` (default: one tick before the first recorded row).
    With ``truncated_head=True`` the first window's opening is unknown
    (ring evicted it): that span is emitted with ``truncated: true`` and
    no milestone/duration claims — explicit ignorance over wrong ticks.
    """
    ticks = np.asarray(cols.tick)
    if ticks.ndim != 1:
        raise ValueError("fold_spans needs [T] columns; use "
                         "PhaseColumns.member(j) for fleet logs")
    if ticks.size == 0:
        return []
    if start_tick is None:
        start_tick = int(ticks[0]) - 1
    milestone_cols = (
        ("first_alert_tick", cols.alert_sent),
        ("first_report_tick", cols.alert_delivered),
        ("first_vote_tick", cols.fast_vote_sent),
        ("fallback_armed_tick", cols.timers_armed),
        ("phase1a_tick", cols.phase1a_sent),
        ("phase1b_tick", cols.phase1b_sent),
        ("phase2a_tick", cols.phase2a_sent),
        ("phase2b_tick", cols.phase2b_sent),
    )
    spans: List[Dict[str, object]] = []
    begin = 0
    window_start = int(start_tick)
    for di in np.flatnonzero(np.asarray(cols.decide)):
        sl = slice(begin, int(di) + 1)
        ms = _blank_milestones()
        for name, arr in milestone_cols:
            ms[name] = _first_positive(arr, sl, ticks)
        ann = np.flatnonzero(np.asarray(cols.announce)[sl])
        if ann.size:
            ms["announce_tick"] = int(ticks[sl][ann[0]])
        decide_tick = int(ticks[di])
        truncate_this = truncated_head and not spans
        spans.append(_make_span(window_start, ms, decide_tick,
                                cols.phases_observed,
                                truncated=truncate_this))
        window_start = decide_tick
        begin = int(di) + 1
    return spans


def lineage_from_recorder(payload: Dict[str, object]
                          ) -> List[Dict[str, object]]:
    """Spans from a flight-recorder payload, with honest truncation.

    When the ring evicted early ticks (``ticks_recorded > window``) the
    first in-ring decide's window opened before the retained range, so
    that span is marked ``truncated``.
    """
    rows = payload.get("rows") or []
    if not rows:
        return []
    cols = ring_phase_columns(payload)
    evicted = int(payload.get("ticks_recorded", len(rows))) > len(rows)
    return fold_spans(cols, truncated_head=evicted)


# ---------------------------------------------------------------------------
# Comparison + summaries
# ---------------------------------------------------------------------------


def comparable(span: Dict[str, object]) -> Dict[str, object]:
    """Projection of a span to oracle-observable fields, for diffing."""
    ms = {k: v for k, v in span["milestones"].items()
          if k not in _ENGINE_ONLY_MILESTONES}
    return {
        "window_start": span["window_start"],
        "decide_tick": span["decide_tick"],
        "ticks_to_view_change": span["ticks_to_view_change"],
        "fallback": span["fallback"],
        "truncated": span["truncated"],
        "milestones": ms,
        "durations": dict(span["durations"]),
    }


def lineage_summary(spans: Sequence[Dict[str, object]]) -> Dict[str, object]:
    """Distribution summary of a span population (schema
    ``LINEAGE_SUMMARY_SPEC``)."""
    from rapid_tpu_torch.telemetry.metrics import _dist

    durations = {}
    for name in LINEAGE_DURATIONS:
        vals = [s["durations"][name] for s in spans
                if s["durations"][name] is not None]
        durations[name] = _dist(vals)
    return {
        "spans": len(spans),
        "fallbacks": sum(1 for s in spans if s["fallback"]),
        "truncated": sum(1 for s in spans if s["truncated"]),
        "durations": durations,
    }


# ---------------------------------------------------------------------------
# Critical-path attribution (per-receiver mode)
# ---------------------------------------------------------------------------


def _rule_for_edge(delays, seed: int, src: int, dst: int,
                   tick: int) -> Optional[int]:
    for i, rule in enumerate(delays):
        if not rule.active(tick):
            continue
        fwd = src in rule.src_slots and dst in rule.dst_slots
        rev = (rule.reverse_delay_ticks >= 0 and src in rule.dst_slots
               and dst in rule.src_slots)
        if (fwd or rev) and delay_of_slots([rule], seed, src, dst, tick) > 0:
            return i
    return None


def receiver_critical_path(mlog, span: Dict[str, object],
                           schedule) -> Optional[Dict[str, object]]:
    """Last-arriving report/vote edge into the deciding slot of ``span``.

    Recomputes per-edge delivery delay with the exact host rule
    (``faults.delay_of_slots``) over the per-slot announce masks of one
    member's ``ReceiverStepLog``: for every slot whose view-change start
    (announce) falls in the span's window, the edge to the deciding slot
    arrives at ``start + 1 + delay``; the critical edge is the latest
    arrival at or before the decide tick (ties -> lowest source slot).
    Returns ``None`` when the span is truncated or no edge is visible.
    """
    if span["truncated"] or span["window_start"] is None:
        return None
    s, d = int(span["window_start"]), int(span["decide_tick"])
    mlog = host_log(mlog, ("tick", "announce", "decide"))
    ticks = np.asarray(mlog.tick)
    announce = np.asarray(mlog.announce).astype(bool)
    decide = np.asarray(mlog.decide).astype(bool)
    di = np.flatnonzero(ticks == d)
    if di.size == 0:
        return None
    deciders = np.flatnonzero(decide[int(di[0])])
    if deciders.size == 0:
        return None
    dst = int(deciders[0])
    window = (ticks > s) & (ticks <= d)
    if not window.any():
        return None
    win_ticks = ticks[window]
    win_ann = announce[window]
    best = None  # (arrival, -src) maximised
    for src in np.flatnonzero(win_ann.any(axis=0)):
        src = int(src)
        first = int(win_ticks[np.flatnonzero(win_ann[:, src])[0]])
        arrival = first + 1 + delay_of_slots(schedule.delays, schedule.seed,
                                             src, dst, first)
        if arrival > d:
            continue
        key = (arrival, -src)
        if best is None or key > best[0]:
            best = (key, src, first, arrival)
    if best is None:
        return None
    _, src, send_tick, arrival = best
    return {
        "src": src,
        "dst": dst,
        "send_tick": send_tick,
        "arrival_tick": arrival,
        "delay_rule": _rule_for_edge(schedule.delays, schedule.seed, src,
                                     dst, send_tick),
    }


# ---------------------------------------------------------------------------
# Streaming fold (chunk-boundary safe)
# ---------------------------------------------------------------------------


class LineageFold:
    """Stateful lineage fold over streaming chunk columns.

    Carries the open window (start tick + partial first-seen milestones)
    across chunk boundaries, so folding a trajectory in chunks of any
    size yields the identical span stream.  State round-trips through
    ``state_dict``/``from_state`` for checkpoint host blobs.
    """

    def __init__(self, start_tick: int = 0) -> None:
        self._window_start = int(start_tick)
        self._ms = _blank_milestones()
        self._phases_observed = True

    def fold(self, rows) -> List[Dict[str, object]]:
        """Fold ``TickMetrics`` rows; returns spans closed this chunk."""
        if not rows:
            return []
        return self.fold_columns(gauge_phase_columns(rows))

    def fold_columns(self, cols: PhaseColumns) -> List[Dict[str, object]]:
        ticks = np.asarray(cols.tick)
        if ticks.size == 0:
            return []
        self._phases_observed = cols.phases_observed
        milestone_cols = (
            ("first_alert_tick", cols.alert_sent),
            ("first_report_tick", cols.alert_delivered),
            ("first_vote_tick", cols.fast_vote_sent),
            ("fallback_armed_tick", cols.timers_armed),
            ("phase1a_tick", cols.phase1a_sent),
            ("phase1b_tick", cols.phase1b_sent),
            ("phase2a_tick", cols.phase2a_sent),
            ("phase2b_tick", cols.phase2b_sent),
        )
        spans: List[Dict[str, object]] = []
        begin = 0
        decide_idx = np.flatnonzero(np.asarray(cols.decide))
        for di in list(decide_idx) + [None]:
            end = ticks.size if di is None else int(di) + 1
            sl = slice(begin, end)
            for name, arr in milestone_cols:
                if self._ms[name] is None:
                    self._ms[name] = _first_positive(arr, sl, ticks)
            if self._ms["announce_tick"] is None:
                ann = np.flatnonzero(np.asarray(cols.announce)[sl])
                if ann.size:
                    self._ms["announce_tick"] = int(ticks[sl][ann[0]])
            if di is None:
                break
            decide_tick = int(ticks[int(di)])
            spans.append(_make_span(self._window_start, self._ms,
                                    decide_tick, self._phases_observed))
            self._window_start = decide_tick
            self._ms = _blank_milestones()
            begin = end
        return spans

    # -- checkpoint state ------------------------------------------------

    def state_dict(self) -> Dict[str, object]:
        return {
            "window_start": self._window_start,
            "milestones": dict(self._ms),
            "phases_observed": self._phases_observed,
        }

    @classmethod
    def from_state(cls, state: Dict[str, object]) -> "LineageFold":
        fold = cls(int(state["window_start"]))
        ms = _blank_milestones()
        for k, v in dict(state.get("milestones", {})).items():
            if k in ms:
                ms[k] = None if v is None else int(v)
        fold._ms = ms
        fold._phases_observed = bool(state.get("phases_observed", True))
        return fold
