"""Unified tick metrics: one record stream per run, and its summaries.

Own copy of the reference's ``telemetry.metrics``. The shared engine
logs per-tick sender and recipient *factors* (``StepLog``) that
``engine.diff.expand_counters`` multiplies into exact message counts;
``engine_metrics`` normalizes them, with the log's end-of-tick gauges,
into ``TickMetrics``, the record ``summarize`` folds into the per-run
``RunSummary`` the benchmarks embed in their payloads. The per-receiver
engine counts its messages directly (``ReceiverStepLog``); its rows come
from ``engine.receiver.receiver_run_payload(...).metrics()``, as in the
reference. ``oracle_metrics`` normalizes a host referee's counter
dicts.

Counter fields (``COUNTER_FIELDS``) are observable on every source;
gauges read ``UNOBSERVED`` where a source does not observe them.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from rapid_tpu_torch.telemetry.trace import span

#: Gauge value on sources that do not observe the gauge.
UNOBSERVED = -1

#: Fields observable on every source.
COUNTER_FIELDS = ("sent", "delivered", "dropped", "timeouts",
                  "probes_sent", "probes_failed")

#: ``StepLog`` fields with a slot axis; no fold reads them whole.
_SLOT_FIELDS = ("proposal", "decision")


def host_log(logs, names: Optional[Sequence[str]] = None):
    """The fields ``names`` (default: every field without a slot axis)
    of a log NamedTuple as numpy arrays, in a ``SimpleNamespace`` that
    lists them in ``_fields`` (so it is a log again). Tensor fields are
    read to the host in one transfer; numpy or JAX arrays pass through
    ``np.asarray``. Bool tensors come back as int64."""
    from rapid_tpu_torch.device import read_arrays

    if names is None:
        names = [n for n in logs._fields if n not in _SLOT_FIELDS]
    vals = {n: getattr(logs, n) for n in names}
    on_device = [n for n, v in vals.items() if torch.is_tensor(v)]
    out = {n: np.asarray(v) for n, v in vals.items()
           if n not in on_device}
    if on_device:
        out.update(zip(on_device,
                       read_arrays(*[vals[n] for n in on_device])))
    return SimpleNamespace(_fields=tuple(names),
                           **{n: out[n] for n in names})


@dataclass(frozen=True)
class TickMetrics:
    """One tick of one source ("engine" | "oracle"), normalized."""

    tick: int
    source: str
    # message counters (exact, host-expanded)
    sent: int = 0
    delivered: int = 0
    dropped: int = 0
    timeouts: int = 0
    probes_sent: int = 0
    probes_failed: int = 0
    # protocol gauges (engine-derived; UNOBSERVED on the oracle)
    n_member: int = UNOBSERVED
    epoch: int = UNOBSERVED
    alerts_in_flight: int = UNOBSERVED
    cut_reports: int = UNOBSERVED
    implicit_reports: int = UNOBSERVED
    vote_tally: int = UNOBSERVED
    quorum: int = UNOBSERVED
    churn_injected: int = UNOBSERVED
    # fault context: directed member edges blocked by active windows and
    # deliveries those windows dropped this tick
    partitioned_edges: int = UNOBSERVED
    link_dropped: int = UNOBSERVED
    # the invariant monitor's bitmask (0 on clean ticks and when off)
    invariant_violations: int = UNOBSERVED
    # consensus-fallback gauges (UNOBSERVED where not observed)
    px_timers_armed: int = UNOBSERVED
    px_coord_round: int = UNOBSERVED
    px_fast_vote_sent: int = UNOBSERVED
    px_phase1a_sent: int = UNOBSERVED
    px_phase1b_sent: int = UNOBSERVED
    px_phase2a_sent: int = UNOBSERVED
    px_phase2b_sent: int = UNOBSERVED
    # protocol events at this tick
    announce: bool = False
    decide: bool = False

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "TickMetrics":
        return TickMetrics(**d)

    def counters(self) -> Dict[str, int]:
        return {f: getattr(self, f) for f in COUNTER_FIELDS}


def counters_equal(a: TickMetrics, b: TickMetrics) -> bool:
    """Equality restricted to the fields both sources observe."""
    return a.tick == b.tick and all(
        getattr(a, f) == getattr(b, f) for f in COUNTER_FIELDS)


# ---------------------------------------------------------------------------
# normalizers
# ---------------------------------------------------------------------------


def engine_metrics(logs) -> List[TickMetrics]:
    """Stacked shared-engine ``StepLog`` rows (``[T]`` per field) as
    TickMetrics: counters from ``diff.expand_counters`` (Python-int
    products), gauges straight off the log."""
    from rapid_tpu_torch.engine.diff import (expand_counters,
                                             expand_fallback_counters)

    logs = host_log(logs)
    counters = expand_counters(logs)
    px = expand_fallback_counters(logs)
    out: List[TickMetrics] = []
    for i, c in enumerate(counters):
        out.append(TickMetrics(
            tick=int(logs.tick[i]), source="engine", **c,
            n_member=int(logs.n_member[i]),
            epoch=int(logs.epoch[i]),
            alerts_in_flight=int(logs.alerts_in_flight[i]),
            cut_reports=int(logs.cut_reports[i]),
            implicit_reports=int(logs.implicit_reports[i]),
            vote_tally=int(logs.vote_tally[i]),
            quorum=int(logs.quorum[i]),
            churn_injected=int(logs.churn_injected[i]),
            partitioned_edges=int(logs.partitioned_edges[i]),
            link_dropped=int(logs.link_dropped[i]),
            invariant_violations=int(logs.inv_bits[i]),
            px_timers_armed=int(logs.px_timers_armed[i]),
            px_coord_round=int(logs.px_coord_round[i]),
            px_fast_vote_sent=px[i]["fast_vote_sent"],
            px_phase1a_sent=px[i]["phase1a_sent"],
            px_phase1b_sent=px[i]["phase1b_sent"],
            px_phase2a_sent=px[i]["phase2a_sent"],
            px_phase2b_sent=px[i]["phase2b_sent"],
            announce=bool(logs.announce_now[i]),
            decide=bool(logs.decide_now[i]),
        ))
    return out


def oracle_metrics(per_tick_counters: Sequence[Dict[str, int]],
                   events: Iterable = (),
                   start_tick: int = 0) -> List[TickMetrics]:
    """A host referee's per-tick counter dicts (the first covering
    ``start_tick + 1``) as TickMetrics; ``events`` (objects with
    ``tick`` and ``kind``) flag announce and decide ticks. Gauges stay
    ``UNOBSERVED``."""
    ann_ticks = {e.tick for e in events if e.kind == "proposal"}
    dec_ticks = {e.tick for e in events if e.kind == "view_change"}
    out: List[TickMetrics] = []
    for i, c in enumerate(per_tick_counters):
        tick = start_tick + 1 + i
        out.append(TickMetrics(
            tick=tick, source="oracle", **c,
            announce=tick in ann_ticks, decide=tick in dec_ticks))
    return out


# ---------------------------------------------------------------------------
# JSONL round-trip
# ---------------------------------------------------------------------------


def write_jsonl(records: Iterable[TickMetrics], path) -> None:
    from rapid_tpu_torch.telemetry import write_jsonl_artifact

    write_jsonl_artifact(path, (r.as_dict() for r in records))


def read_jsonl(path) -> List[TickMetrics]:
    out: List[TickMetrics] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(TickMetrics.from_dict(json.loads(line)))
    return out


# ---------------------------------------------------------------------------
# per-run summaries
# ---------------------------------------------------------------------------


@dataclass
class RunSummary:
    """Protocol-level summary of one run. ``view_changes`` has one record
    per decide: its announce and decide ticks, the ticks from the start
    of its window (the run's start or the previous decide), and the
    messages sent and delivered in that window."""

    source: str
    n_ticks: int
    announcements: int
    decisions: int
    ticks_to_first_announce: Optional[int]
    ticks_to_first_decide: Optional[int]
    messages_per_view_change: Optional[float]
    view_changes: List[Dict[str, object]]
    total_sent: int
    total_delivered: int
    total_dropped: int
    total_timeouts: int
    total_probes_sent: int
    total_probes_failed: int
    # ticks whose invariant bitmask was nonzero
    invariant_violations: int = 0
    # consensus traffic per phase (UNOBSERVED rows stay out of the sums)
    fallback_phase_sent: Dict[str, int] = field(default_factory=dict)
    # the peak partitioned-edge gauge and the link-window drops
    max_partitioned_edges: int = 0
    total_link_dropped: int = 0

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def summarize(metrics: Sequence[TickMetrics]) -> RunSummary:
    """Fold a TickMetrics stream into a RunSummary."""
    with span("rapid.fold"):
        return _summarize(metrics)


def _summarize(metrics: Sequence[TickMetrics]) -> RunSummary:
    start_tick = metrics[0].tick - 1 if metrics else 0
    first_announce: Optional[int] = None
    first_decide: Optional[int] = None
    announcements = 0
    decisions = 0
    view_changes: List[Dict[str, object]] = []
    window_start = start_tick
    window_announce: Optional[int] = None
    window_sent = 0
    window_delivered = 0
    totals = dict.fromkeys(COUNTER_FIELDS, 0)
    px_fields = (("fast_vote", "px_fast_vote_sent"),
                 ("phase1a", "px_phase1a_sent"),
                 ("phase1b", "px_phase1b_sent"),
                 ("phase2a", "px_phase2a_sent"),
                 ("phase2b", "px_phase2b_sent"))
    px_totals = {phase: 0 for phase, _ in px_fields}
    inv_ticks = 0
    max_part_edges = 0
    link_dropped_total = 0

    for m in metrics:
        if m.invariant_violations > 0:
            inv_ticks += 1
        if m.partitioned_edges > max_part_edges:
            max_part_edges = m.partitioned_edges
        if m.link_dropped > 0:
            link_dropped_total += m.link_dropped
        for f in COUNTER_FIELDS:
            totals[f] += getattr(m, f)
        for phase, attr in px_fields:
            v = getattr(m, attr)
            if v >= 0:
                px_totals[phase] += v
        window_sent += m.sent
        window_delivered += m.delivered
        if m.announce:
            announcements += 1
            window_announce = m.tick
            if first_announce is None:
                first_announce = m.tick
        if m.decide:
            decisions += 1
            if first_decide is None:
                first_decide = m.tick
            view_changes.append({
                "announce_tick": window_announce,
                "decide_tick": m.tick,
                "ticks_to_decide": m.tick - window_start,
                "messages_sent": window_sent,
                "messages_delivered": window_delivered,
            })
            window_start = m.tick
            window_announce = None
            window_sent = 0
            window_delivered = 0

    per_vc = (sum(v["messages_sent"] for v in view_changes)
              / len(view_changes)) if view_changes else None
    return RunSummary(
        source=metrics[0].source if metrics else "empty",
        n_ticks=len(metrics),
        announcements=announcements,
        decisions=decisions,
        ticks_to_first_announce=(first_announce - start_tick
                                 if first_announce is not None else None),
        ticks_to_first_decide=(first_decide - start_tick
                               if first_decide is not None else None),
        messages_per_view_change=per_vc,
        view_changes=view_changes,
        total_sent=totals["sent"],
        total_delivered=totals["delivered"],
        total_dropped=totals["dropped"],
        total_timeouts=totals["timeouts"],
        total_probes_sent=totals["probes_sent"],
        total_probes_failed=totals["probes_failed"],
        invariant_violations=inv_ticks,
        fallback_phase_sent=px_totals,
        max_partitioned_edges=max_part_edges,
        total_link_dropped=link_dropped_total,
    )


# ---------------------------------------------------------------------------
# fleet folds: many independent clusters, one aggregate + distributions
# ---------------------------------------------------------------------------


def fleet_summaries(logs) -> List[RunSummary]:
    """Per-member ``RunSummary`` list from a shared fleet's member-major
    ``StepLog`` (``[F, T, ...]``): each member's slice through
    ``engine_metrics`` and ``summarize``, after one read of the fleet's
    fields to the host."""
    with span("rapid.fold"):
        logs = host_log(logs)
        return [summarize(engine_metrics(SimpleNamespace(
            _fields=logs._fields,
            **{k: getattr(logs, k)[i] for k in logs._fields})))
            for i in range(logs.tick.shape[0])]


def merge_summaries(summaries: Sequence[RunSummary],
                    source: str = "fleet") -> RunSummary:
    """Fold per-member summaries into one fleet aggregate, each field as
    ``schema.GAUGE_SEMANTICS`` says: counters sum, the peak
    partitioned-edge gauge takes the max, ``ticks_to_first_*`` the
    earliest member; ``view_changes`` rows are dropped (across clusters
    they are a distribution, ``summary_distributions``)."""
    if not summaries:
        raise ValueError("cannot merge an empty fleet")
    decisions = sum(s.decisions for s in summaries)
    window_sent = sum(v["messages_sent"] for s in summaries
                      for v in s.view_changes)
    firsts_a = [s.ticks_to_first_announce for s in summaries
                if s.ticks_to_first_announce is not None]
    firsts_d = [s.ticks_to_first_decide for s in summaries
                if s.ticks_to_first_decide is not None]
    phases = sorted({p for s in summaries for p in s.fallback_phase_sent})
    return RunSummary(
        source=source,
        n_ticks=max(s.n_ticks for s in summaries),
        announcements=sum(s.announcements for s in summaries),
        decisions=decisions,
        ticks_to_first_announce=min(firsts_a) if firsts_a else None,
        ticks_to_first_decide=min(firsts_d) if firsts_d else None,
        messages_per_view_change=(window_sent / decisions
                                  if decisions else None),
        view_changes=[],
        total_sent=sum(s.total_sent for s in summaries),
        total_delivered=sum(s.total_delivered for s in summaries),
        total_dropped=sum(s.total_dropped for s in summaries),
        total_timeouts=sum(s.total_timeouts for s in summaries),
        total_probes_sent=sum(s.total_probes_sent for s in summaries),
        total_probes_failed=sum(s.total_probes_failed for s in summaries),
        invariant_violations=sum(s.invariant_violations for s in summaries),
        fallback_phase_sent={
            p: sum(s.fallback_phase_sent.get(p, 0) for s in summaries)
            for p in phases},
        max_partitioned_edges=max(s.max_partitioned_edges
                                  for s in summaries),
        total_link_dropped=sum(s.total_link_dropped for s in summaries),
    )


def _nearest_rank(values: Sequence[float], pct: float) -> float:
    """Nearest-rank percentile of a non-empty sorted list (no
    interpolation, so payloads diff exactly)."""
    idx = max(0, -(-int(pct * len(values)) // 100) - 1)
    return values[min(idx, len(values) - 1)]


def _dist(values: Sequence[float]) -> Dict[str, object]:
    vals = sorted(values)
    if not vals:
        return {"count": 0, "p50": None, "p90": None, "p99": None,
                "max": None}
    return {"count": len(vals),
            "p50": _nearest_rank(vals, 50), "p90": _nearest_rank(vals, 90),
            "p99": _nearest_rank(vals, 99), "max": vals[-1]}


def regime_distributions(
        ticks_by_regime: Dict[str, Sequence[float]]) -> Dict[str, object]:
    """``ticks_to_first_decide`` distributions keyed by delay regime, each
    ``{count, p50, p90, p99, max}`` over the members that decided."""
    return {k: _dist(v) for k, v in sorted(ticks_by_regime.items())}


def summary_distributions(
        summaries: Sequence[RunSummary]) -> Dict[str, object]:
    """Campaign distributions over per-member summaries: decide and
    fallback and violation rates, and nearest-rank percentiles of ticks
    to the first decide, messages sent, messages per view change and
    decisions."""
    n = len(summaries)
    decided = [s for s in summaries if s.ticks_to_first_decide is not None]
    fallback = [s for s in summaries
                if sum(v for p, v in s.fallback_phase_sent.items()
                       if p != "fast_vote") > 0]
    violated = [s for s in summaries if s.invariant_violations > 0]
    return {
        "clusters": n,
        "decided_clusters": len(decided),
        "decide_rate": len(decided) / n if n else None,
        "fallback_clusters": len(fallback),
        "violation_rate": len(violated) / n if n else None,
        "ticks_to_first_decide": _dist(
            [s.ticks_to_first_decide for s in decided]),
        "total_sent": _dist([s.total_sent for s in summaries]),
        "messages_per_view_change": _dist(
            [s.messages_per_view_change for s in summaries
             if s.messages_per_view_change is not None]),
        "decisions": _dist([s.decisions for s in summaries]),
    }
