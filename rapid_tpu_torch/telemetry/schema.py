"""Payload validation for what the port writes (no external deps).

Own copy of the validators of the reference's ``telemetry.schema`` that
cover the port's payloads: per-run telemetry blocks
(``metrics.RunSummary.as_dict``), flight-recorder payloads, lineage spans
and summaries, SLO windows, and single-run, sweep and suite bench
payloads. Each validator returns a list of violations, empty when the
payload is well formed; the constants pin the field names and fold
semantics the folds and the recorder write.

Not here yet: the validators of the campaign, dispatch timeline,
progress, streaming, checkpoint, load-sweep, status and kernel-profile
payloads, which wait for the modules that write them (``ROADMAP.md``
Queue 1 items 5-7); ``validate_run_payload`` and
``validate_bench_payload`` raise ``NotImplementedError`` on such a
payload rather than pass it unchecked.
"""
from __future__ import annotations

from typing import Dict, List

_NUM = (int, float)
_OPT_INT = (int, type(None))

#: Version of the telemetry payload contract, the reference's.
SCHEMA_VERSION = 12

#: Fold semantics of every RunSummary gauge when aggregated over a fleet
#: axis (``telemetry.metrics.merge_summaries``). "total" gauges sum
#: across independent clusters; "max" gauges are per-cluster peaks where
#: a sum would fabricate a value no cluster ever observed; "min" gauges
#: are earliest-member times whose per-member spread belongs in the
#: campaign distributions instead.
GAUGE_SEMANTICS = {
    "announcements": "total",
    "decisions": "total",
    "ticks_to_first_announce": "min",
    "ticks_to_first_decide": "min",
    "total_sent": "total",
    "total_delivered": "total",
    "total_dropped": "total",
    "total_timeouts": "total",
    "total_probes_sent": "total",
    "total_probes_failed": "total",
    "invariant_violations": "total",
    "fallback_phase_sent": "total",       # per phase
    "max_partitioned_edges": "max",       # peak per-tick gauge
    "total_link_dropped": "total",
}

#: RunSummary.as_dict() — the per-run "telemetry" block.
TELEMETRY_SPEC = {
    "source": (str,),
    "n_ticks": (int,),
    "announcements": (int,),
    "decisions": (int,),
    "ticks_to_first_announce": _OPT_INT,
    "ticks_to_first_decide": _OPT_INT,
    "messages_per_view_change": (int, float, type(None)),
    "view_changes": (list,),
    "total_sent": (int,),
    "total_delivered": (int,),
    "total_dropped": (int,),
    "total_timeouts": (int,),
    "total_probes_sent": (int,),
    "total_probes_failed": (int,),
    "invariant_violations": (int,),
    "fallback_phase_sent": (dict,),
    "max_partitioned_edges": (int,),
    "total_link_dropped": (int,),
}

#: Keys of the fallback_phase_sent block (matches engine.diff._PX_CLASSES
#: and the oracle's SimNetwork consensus phases).
FALLBACK_PHASES = ("fast_vote", "phase1a", "phase1b", "phase2a", "phase2b")

VIEW_CHANGE_SPEC = {
    "announce_tick": _OPT_INT,
    "decide_tick": (int,),
    "ticks_to_decide": (int,),
    "messages_sent": (int,),
    "messages_delivered": (int,),
}

#: Required fields of one single-run bench payload. Rates are ``null``
#: when the measured wall is below the minimum measurable floor: a
#: sub-millisecond wall divided into a tick count is noise.
RUN_SPEC = {
    "bench": (str,),
    "n": (int,),
    "ticks": (int,),
    "wall_s": _NUM,
    "ticks_per_sec": (int, float, type(None)),
    "rounds_per_sec": (int, float, type(None)),
    "telemetry": (dict,),
}

#: First-occurrence tick stamps of a flight-recorder payload (-1 ==
#: never observed inside the run).
RECORDER_STAMPS = ("first_announce", "first_decide", "first_fallback",
                   "first_violation")

#: One extracted flight-recorder ring
#: (``engine.recorder.recorder_payload``): the last ``window`` per-tick
#: gauge rows in chronological order (row length == len(gauges), -1 ==
#: gauge unobserved by that engine) plus the first-occurrence stamps.
FLIGHT_RECORDER_SPEC = {
    "window": (int,),
    "gauges": (list,),
    "ticks_recorded": (int,),
    "rows": (list,),
    "stamps": (dict,),
}

#: One nearest-rank distribution block (``metrics.summary_distributions``).
DISTRIBUTION_SPEC = {
    "count": (int,),
    "p50": (int, float, type(None)),
    "p90": (int, float, type(None)),
    "p99": (int, float, type(None)),
    "max": (int, float, type(None)),
}

#: Phase-duration names of one lineage span, in pipeline order
#: (``telemetry.lineage.LINEAGE_DURATIONS``, repeated so this module
#: imports nothing; a test pins the two equal).
#: For every non-truncated span they sum to ``ticks_to_view_change``.
LINEAGE_DURATION_NAMES = ("dissemination_ticks", "cut_fill_ticks",
                          "fast_vote_wait", "fallback_wait",
                          "classic_phase_ticks")

#: Phase-boundary milestone ticks of one lineage span (null == that
#: boundary was not observed in the span's window).
LINEAGE_MILESTONE_NAMES = ("first_alert_tick", "first_report_tick",
                           "announce_tick", "first_vote_tick",
                           "fallback_armed_tick", "phase1a_tick",
                           "phase1b_tick", "phase2a_tick",
                           "phase2b_tick")

#: One per-view-change lineage span (``telemetry.lineage.fold_spans``).
#: ``truncated`` spans carry a decide tick and nothing else — a
#: recorder-ring-evicted window degrades to explicit ignorance, never
#: to wrong ticks.
LINEAGE_SPAN_SPEC = {
    "window_start": _OPT_INT,
    "decide_tick": (int,),
    "ticks_to_view_change": _OPT_INT,
    "fallback": (bool,),
    "truncated": (bool,),
    "milestones": (dict,),
    "durations": (dict,),
    "critical_path": (dict, type(None)),
}

#: Critical-path attribution of a per-receiver span: the last-arriving
#: report/vote edge into the deciding slot, and the index of the
#: ``DelayRule`` covering that edge (null when no rule slowed it).
LINEAGE_CRITICAL_PATH_SPEC = {
    "src": (int,),
    "dst": (int,),
    "send_tick": (int,),
    "arrival_tick": (int,),
    "delay_rule": _OPT_INT,
}

#: A lineage span-population summary
#: (``telemetry.lineage.lineage_summary``): span/fallback/truncated
#: counts plus one DISTRIBUTION_SPEC block per phase duration.
LINEAGE_SUMMARY_SPEC = {
    "spans": (int,),
    "fallbacks": (int,),
    "truncated": (int,),
    "durations": (dict,),
}

SLO_METRIC_NAMES = ("decide_latency", "ticks_to_view_change")

#: One windowed metric: bucket counts over the window plus nearest-rank
#: percentiles as bucket upper edges (null when the window is empty).
SLO_METRIC_SPEC = {
    "count": (int,),
    "counts": (list,),
    "p50": _OPT_INT,
    "p95": _OPT_INT,
    "p99": _OPT_INT,
}

#: The rolling ``slo`` heartbeat block (``telemetry.slo.SloWindows``).
SLO_WINDOW_SPEC = {
    "window_chunks": (int,),
    "chunks": (int,),
    "bucket_edges": (list,),
    "metrics": (dict,),
}

def _check(obj: Dict, spec: Dict, where: str) -> List[str]:
    errors = []
    if not isinstance(obj, dict):
        return [f"{where}: expected an object, got {type(obj).__name__}"]
    for key, types in spec.items():
        if key not in obj:
            errors.append(f"{where}.{key}: missing")
        elif not isinstance(obj[key], types) or (
                isinstance(obj[key], bool) and bool not in types):
            errors.append(
                f"{where}.{key}: expected "
                f"{'/'.join(t.__name__ for t in types)}, "
                f"got {type(obj[key]).__name__}")
    return errors


def validate_telemetry(block, where: str = "telemetry") -> List[str]:
    errors = _check(block, TELEMETRY_SPEC, where)
    if isinstance(block, dict):
        for i, vc in enumerate(block.get("view_changes") or []):
            errors += _check(vc, VIEW_CHANGE_SPEC,
                             f"{where}.view_changes[{i}]")
        px = block.get("fallback_phase_sent")
        if isinstance(px, dict):
            errors += _check(
                px, {phase: (int,) for phase in FALLBACK_PHASES},
                f"{where}.fallback_phase_sent")
    return errors


def validate_flight_recorder(block, where: str = "recorder") -> List[str]:
    """Validate one extracted flight-recorder ring payload."""
    errors = _check(block, FLIGHT_RECORDER_SPEC, where)
    if not isinstance(block, dict):
        return errors
    gauges = block.get("gauges")
    n_gauges = len(gauges) if isinstance(gauges, list) else None
    rows = block.get("rows")
    if isinstance(rows, list):
        window = block.get("window")
        if isinstance(window, int) and not isinstance(window, bool) \
                and len(rows) > window:
            errors.append(f"{where}.rows: {len(rows)} rows exceed "
                          f"window={window}")
        for i, row in enumerate(rows):
            if not isinstance(row, list):
                errors.append(f"{where}.rows[{i}]: expected list, "
                              f"got {type(row).__name__}")
            elif n_gauges is not None and len(row) != n_gauges:
                errors.append(f"{where}.rows[{i}]: {len(row)} values for "
                              f"{n_gauges} gauges")
    stamps = block.get("stamps")
    if isinstance(stamps, dict):
        errors += _check(stamps, {s: (int,) for s in RECORDER_STAMPS},
                         f"{where}.stamps")
    return errors


def validate_lineage_span(span, where: str = "lineage_span") -> List[str]:
    """Validate one per-view-change lineage span (schema v12)."""
    errors = _check(span, LINEAGE_SPAN_SPEC, where)
    if not isinstance(span, dict):
        return errors
    if isinstance(span.get("milestones"), dict):
        errors += _check(span["milestones"],
                         {name: _OPT_INT for name in
                          LINEAGE_MILESTONE_NAMES},
                         f"{where}.milestones")
    if isinstance(span.get("durations"), dict):
        errors += _check(span["durations"],
                         {name: _OPT_INT for name in
                          LINEAGE_DURATION_NAMES},
                         f"{where}.durations")
    if isinstance(span.get("critical_path"), dict):
        errors += _check(span["critical_path"], LINEAGE_CRITICAL_PATH_SPEC,
                         f"{where}.critical_path")
    return errors


def validate_lineage_summary(block, where: str = "lineage") -> List[str]:
    """Validate one lineage span-population summary (schema v12): every
    phase duration must carry a distribution block, even when empty."""
    errors = _check(block, LINEAGE_SUMMARY_SPEC, where)
    if not isinstance(block, dict):
        return errors
    durs = block.get("durations")
    if isinstance(durs, dict):
        for name in LINEAGE_DURATION_NAMES:
            if name not in durs:
                errors.append(f"{where}.durations.{name}: missing")
        for name, dist in durs.items():
            if name not in LINEAGE_DURATION_NAMES:
                errors.append(f"{where}.durations.{name}: unknown "
                              f"duration (expected one of "
                              f"{'/'.join(LINEAGE_DURATION_NAMES)})")
            errors += _check(dist, DISTRIBUTION_SPEC,
                             f"{where}.durations.{name}")
    return errors


def validate_slo_window(block, where: str = "slo") -> List[str]:
    """Validate one rolling ``slo`` window block (schema v10): both
    metrics present, each count vector exactly one bucket per edge and
    summing to its ``count``."""
    errors = _check(block, SLO_WINDOW_SPEC, where)
    if not isinstance(block, dict):
        return errors
    edges = block.get("bucket_edges")
    n_edges = len(edges) if isinstance(edges, list) else None
    metrics = block.get("metrics")
    if not isinstance(metrics, dict):
        return errors
    for name in SLO_METRIC_NAMES:
        if name not in metrics:
            errors.append(f"{where}.metrics.{name}: missing")
    for name, metric in metrics.items():
        mw = f"{where}.metrics.{name}"
        if name not in SLO_METRIC_NAMES:
            errors.append(f"{mw}: unknown metric (expected one of "
                          f"{'/'.join(SLO_METRIC_NAMES)})")
        errors += _check(metric, SLO_METRIC_SPEC, mw)
        if not isinstance(metric, dict):
            continue
        counts = metric.get("counts")
        if isinstance(counts, list):
            if n_edges is not None and len(counts) != n_edges:
                errors.append(f"{mw}.counts: {len(counts)} buckets for "
                              f"{n_edges} edges")
            total = sum(c for c in counts
                        if isinstance(c, int) and not isinstance(c, bool))
            if isinstance(metric.get("count"), int) \
                    and metric["count"] != total:
                errors.append(f"{mw}.count: {metric['count']} != "
                              f"sum(counts) = {total}")
    return errors


def validate_run_payload(payload, where: str = "payload") -> List[str]:
    """One single-run bench payload: ``RUN_SPEC`` and its telemetry
    block. Streaming and campaign payloads are not validated here yet
    (``NotImplementedError``)."""
    if isinstance(payload, dict) and (payload.get("scenario") == "streaming"
                                      or "campaign" in payload):
        raise NotImplementedError(
            f"{where}: streaming and campaign payloads wait for ROADMAP.md "
            f"Queue 1 items 5-6")
    errors = _check(payload, RUN_SPEC, where)
    if isinstance(payload, dict) and isinstance(payload.get("telemetry"),
                                                dict):
        errors += validate_telemetry(payload["telemetry"],
                                     f"{where}.telemetry")
    return errors


def _version_errors(payload) -> List[str]:
    v = payload.get("schema_version")
    if v is None:
        return ["payload.schema_version: missing"]
    if not isinstance(v, int) or isinstance(v, bool):
        return [f"payload.schema_version: expected int, "
                f"got {type(v).__name__}"]
    if v != SCHEMA_VERSION:
        return [f"payload.schema_version: expected {SCHEMA_VERSION}, "
                f"got {v}"]
    return []


def validate_bench_payload(payload) -> List[str]:
    """Validate a single-run, sweep or suite payload. Top-level payloads
    must carry a matching ``schema_version``."""
    if not isinstance(payload, dict):
        return ["payload: expected a JSON object"]
    errors = _version_errors(payload)
    if payload.get("bench") == "kernel_profile_sweep":
        raise NotImplementedError(
            "payload: kernel-profile payloads have no port validator")
    if payload.get("bench") == "engine_tick_suite":
        for key in ("steady", "churn", "contested", "partition", "delay",
                    "streaming", "fleet"):
            if key not in payload:
                errors.append(f"payload.{key}: missing")
            else:
                errors += validate_run_payload(payload[key],
                                               f"payload.{key}")
        return errors
    if "sweep" in payload:
        for i, run in enumerate(payload["sweep"]):
            errors += validate_run_payload(run, f"payload.sweep[{i}]")
        return errors
    return errors + validate_run_payload(payload)
