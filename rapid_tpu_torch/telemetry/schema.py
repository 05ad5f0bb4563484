"""Payload validation for what the port writes (no external deps).

Own copy of the validators of the reference's ``telemetry.schema`` that
cover the port's payloads: per-run telemetry blocks
(``metrics.RunSummary.as_dict``), flight-recorder payloads, lineage spans
and summaries, SLO windows, single-run, sweep and suite bench payloads,
campaign payloads with their triage, tournament, dispatch timeline,
observatory and ``--progress`` heartbeat records, and the streaming
service's chunk heartbeats, stream summaries, servo blocks, status
snapshots, load sweeps and checkpoint manifests, and the kernel-cost
observatory's dominance report (``telemetry.profile``). Each validator
returns a list of violations, empty when the payload is well formed; the
constants pin the field names and fold semantics the folds, the
recorder, the campaign, the service and the observatory write.

    python -m rapid_tpu_torch.telemetry.schema \
        [--progress|--streaming|--load-sweep|--status] FILE

checks one artifact as the reference's CLI does: exit 0 when it is well
formed, 1 with one line per violation, 2 on a usage error.
"""
from __future__ import annotations

import json
import sys
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

#: One per-kernel cost record of the kernel-cost observatory
#: (``telemetry.profile.KernelCost.as_dict``).
KERNEL_COST_SPEC = {
    "kernel": (str,),
    "flops": _NUM,
    "bytes_accessed": _NUM,
    "argument_bytes": (int,),
    "output_bytes": (int,),
    "temp_bytes": (int,),
    "peak_bytes": (int,),
    "compile_s": _NUM,
    "wall_median_s": _NUM,
    "wall_best_s": _NUM,
    "repeats": (int,),
}

#: One per-N entry of the dominance report.
PROFILE_RUN_SPEC = {
    "n": (int,),
    "capacity": (int,),
    "kernels": (list,),
    "dominant": (dict,),
}

#: Top level of the ``kernel_profile_sweep`` dominance report.
PROFILE_SWEEP_SPEC = {
    "bench": (str,),
    "platform": (str,),
    "k": (int,),
    "sizes": (list,),
    "runs": (list,),
    "dominant_by_n": (dict,),
}

#: Sharded-vs-single-device block of the dominance report. The top-level
#: ``multichip`` key may be ``null`` (not enough devices); when present it
#: must carry these fields.
MULTICHIP_SPEC = {
    "n_devices": (int,),
    "axis": (str,),
    "kernels": (list,),
}

MULTICHIP_ENTRY_SPEC = {
    "kernel": (str,),
    "n": (int,),
    "single_wall_median_s": _NUM,
    "sharded_wall_median_s": _NUM,
    "speedup": (int, float, type(None)),
}

#: Per-receiver fleet-step memory block of the dominance report
#: (``telemetry.profile.receiver_memory_block``). Like ``multichip``, the
#: top-level ``receiver_memory`` key may be ``null`` ("not measured").
RECEIVER_MEMORY_SPEC = {
    "n": (int,),
    "capacity": (int,),
    "k": (int,),
    "member_state_bytes": (int,),
    "fleets": (list,),
}

RECEIVER_FLEET_ENTRY_SPEC = {
    "fleet_size": (int,),
    "argument_bytes": (int,),
    "output_bytes": (int,),
    "temp_bytes": (int,),
    "peak_bytes": (int,),
    "compile_s": _NUM,
}

#: Protocol-variant kernel block of the dominance report
#: (``telemetry.profile.variant_sweep_block``). The top-level ``variants``
#: key may be ``null`` ("not measured"); when present it carries the
#: measured ring aggregation kernels plus the documented dense-broadcast
#: refusals, sizes where the O(N^2) kernel would exceed the budget.
VARIANT_SPEC = {
    "sizes": (list,),
    "budget_bytes": (int,),
    "kernels": (list,),
    "refusals": (list,),
}

#: One documented refusal of the variant block: the kernel that was *not*
#: run, at which size, the bytes it would have needed against the budget,
#: and the one-line reason.
VARIANT_REFUSAL_SPEC = {
    "kernel": (str,),
    "n": (int,),
    "bytes_required": (int,),
    "budget_bytes": (int,),
    "reason": (str,),
}

#: One measured variant kernel entry: a KERNEL_COST_SPEC record plus the
#: size it ran at.
VARIANT_KERNEL_SPEC = dict(KERNEL_COST_SPEC, n=(int,))

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

# --- streaming service records (schema v9) --------------------------------

#: The ``TrafficConfig.as_dict()`` block embedded in streaming records.
TRAFFIC_CONFIG_SPEC = {
    "seed": (int,),
    "join_rate_per_ktick": _NUM,
    "leave_burst_rate_per_ktick": _NUM,
    "leave_burst_size": (int,),
    "diurnal_amplitude": _NUM,
    "diurnal_period_ticks": (int,),
    "burst_spacing_ticks": (int,),
    "max_join_burst": (int,),
    "min_members": (int,),
    "reuse_slots": (bool,),
    # Schema v10: closed-loop sampling (one uniform per tick, Poisson by
    # CDF inversion) — the mode the load servo requires.
    "closed_loop": (bool,),
}

#: Per-chunk traffic lowering counts (``TrafficGenerator.next_chunk``
#: info block).
STREAM_TRAFFIC_INFO_SPEC = {
    "bursts": (int,),
    "joins": (int,),
    "leaves": (int,),
    "backlog_joins": (int,),
    "backlog_leaves": (int,),
    "n_members": (int,),
    "events": (int,),
}

#: The checkpoint-proof block of a save/restore round trip
#: (``ResidentEngine.verify_round_trip``). Boolean ``*_identical``
#: fields are the bit-exactness verdicts; the recorder pair is null when
#: the run has no flight recorder.
STREAM_CHECKPOINT_SPEC = {
    "version": (int,),
    "tick": (int,),
    "state_identical": (bool,),
    "recorder_identical": (bool, type(None)),
    "logs_identical": (bool,),
    "final_identical": (bool,),
    "continuation_recorder_identical": (bool, type(None)),
}

#: One ``record: "chunk"`` heartbeat of the resident-engine JSONL
#: stream. ``traffic`` is null when no generator is attached;
#: ``checkpoint`` is non-null only on the chunk that performed a
#: save/restore round trip.
STREAM_CHUNK_SPEC = {
    "record": (str,),
    "index": (int,),
    "tick": (int,),
    "ticks": (int,),
    "wall_s": _NUM,
    # Schema v10: chunk 0 splits the one-time trace+compile wall out of
    # ``wall_s`` (null on every later chunk), so heartbeat rates — and
    # the servo's control input — measure execution, not the compiler.
    "compile_s": (int, float, type(None)),
    "ticks_per_sec": (int, float, type(None)),
    "events_per_sec": (int, float, type(None)),
    "announces": (int,),
    "decides": (int,),
    "live_buffer_bytes": (int,),
    "traffic": (dict, type(None)),
    # Schema v10: null unless a LoadServo / SloWindows is attached.
    "servo": (dict, type(None)),
    "slo": (dict, type(None)),
    # Schema v12: rolling last-window lineage summary (null before the
    # first folded chunk).
    "lineage": (dict, type(None)),
    "checkpoint": (dict, type(None)),
}

#: Live-buffer watermark block of the stream summary. ``steady_max``
#: excludes checkpoint-verify chunks (those transiently hold the live
#: and restored branches side by side) — the flat-memory soak gate
#: compares it against ``first``.
STREAM_WATERMARK_SPEC = {
    "first": _OPT_INT,
    "max": _OPT_INT,
    "steady_max": _OPT_INT,
    "last": _OPT_INT,
}

#: The final ``record: "stream_summary"`` line of a resident run (also
#: the ``summary`` block of a committed soak artifact).
STREAM_SUMMARY_SPEC = {
    "record": (str,),
    "schema_version": (int,),
    "source": (str,),
    "n": (int,),
    "capacity": (int,),
    "ticks": (int,),
    "chunks": (int,),
    "chunk_ticks": (int,),
    "events_injected": (int,),
    "joins": (int,),
    "leaves": (int,),
    "bursts": (int,),
    "announcements": (int,),
    "decisions": (int,),
    "wall_s": _NUM,
    "compile_s": (int, float, type(None)),
    "ticks_per_sec": (int, float, type(None)),
    "events_per_sec": (int, float, type(None)),
    "ticks_to_view_change": (dict,),
    "live_buffer_bytes": (dict,),
    "traffic": (dict, type(None)),
    # Schema v10: the final servo state ({"config", "final"}) and the
    # final rolling SLO window; null when not attached.
    "servo": (dict, type(None)),
    "slo": (dict, type(None)),
    # Schema v12: whole-run lineage summary (null when the run folded
    # no lineage).
    "lineage": (dict, type(None)),
    "checkpoint": (dict, type(None)),
}

# --- streaming observatory records (schema v10) ---------------------------

#: ``service.servo.ServoConfig.as_dict()`` — the control-law constants
#: a committed sweep is exactly reproducible from.
SERVO_CONFIG_SPEC = {
    "target_events_per_sec": _NUM,
    "initial_ticks_per_sec": _NUM,
    "pinned_ticks_per_sec": (int, float, type(None)),
    "gain": _NUM,
    "rate_quantum_per_ktick": _NUM,
    "min_rate_per_ktick": _NUM,
    "max_rate_per_ktick": _NUM,
    "tps_quantum": _NUM,
}

#: The per-chunk ``servo`` heartbeat block
#: (``LoadServo.chunk_block``): ``rate_per_ktick`` is the quantized
#: rate the chunk actually ran at, ``backlog`` the generator's
#: offered-minus-applied saturation observable.
SERVO_CHUNK_SPEC = {
    "target_events_per_sec": _NUM,
    "rate_per_ktick": _NUM,
    "ticks_per_sec_estimate": _NUM,
    "backlog": (int,),
    "updates": (int,),
}

#: One ``record: "status_snapshot"`` line of the live status API
#: (``service.status``) — the latest chunk-boundary picture, built
#: purely from already-drained host data.
STATUS_SNAPSHOT_SPEC = {
    "record": (str,),
    "schema_version": (int,),
    "source": (str,),
    "tick": (int,),
    "chunks": (int,),
    "epoch": (int,),
    "n_members": (int,),
    "ticks_per_sec": (int, float, type(None)),
    "events_per_sec": (int, float, type(None)),
    "backlog": (int, type(None)),
    "live_buffer_bytes": (int,),
    "servo": (dict, type(None)),
    "slo": (dict, type(None)),
    # Schema v12: the last chunk's rolling lineage summary.
    "lineage": (dict, type(None)),
    "checkpoint": (dict, type(None)),
    "wall_s": _NUM,
}

#: One target of a ``record: "load_sweep"`` saturation sweep: the servo
#: config it ran under, what it achieved, and the stability verdict
#: (bounded backlog slope over the measured chunks).
LOAD_SWEEP_RATE_SPEC = {
    "target_events_per_sec": _NUM,
    "achieved_events_per_sec": (int, float, type(None)),
    "rate_per_ktick": _NUM,
    "ticks_per_sec": (int, float, type(None)),
    "chunks": (int,),
    "events": (int,),
    "backlog_final": (int,),
    "backlog_slope_per_chunk": _NUM,
    "stable": (bool,),
    "servo_config": (dict,),
    "slo": (dict,),
}

#: The measured knee: the largest stable target (null when every
#: target was unstable), with its achieved rate and windowed tail.
LOAD_SWEEP_KNEE_SPEC = {
    "target_events_per_sec": (int, float, type(None)),
    "achieved_events_per_sec": (int, float, type(None)),
    "ticks_to_view_change_p99": _OPT_INT,
}

#: The ``record: "load_sweep"`` artifact (``benchmarks/load_sweep.json``,
#: ``python -m rapid_tpu_torch.service --load-sweep``).
LOAD_SWEEP_SPEC = {
    "record": (str,),
    "schema_version": (int,),
    "n": (int,),
    "capacity": (int,),
    "chunk_ticks": (int,),
    "chunks_per_rate": (int,),
    "warmup_chunks": (int,),
    "seed": (int,),
    "backlog_slope_threshold": _NUM,
    "targets": (list,),
    "rates": (list,),
    "knee": (dict, type(None)),
    "wall_s": _NUM,
}

#: ``service.checkpoint`` manifest (``manifest.json`` inside a
#: checkpoint directory). ``checkpoint_version`` is the restore
#: compatibility pin — distinct from the telemetry ``schema_version``
#: the manifest also stamps.
CHECKPOINT_MANIFEST_SPEC = {
    "record": (str,),
    "checkpoint_version": (int,),
    "schema_version": (int,),
    "family": (str,),
    "tick": (int,),
    "statics": (dict,),
    "leaves": (list,),
    "host": (dict, type(None)),
}

CHECKPOINT_LEAF_SPEC = {
    "name": (str,),
    "dtype": (str,),
    "shape": (list,),
}

#: Protocol variants a campaign or replay payload may record
#: (``rapid_tpu_torch.variants.VARIANTS``, repeated so this module
#: imports nothing; a test pins the two equal).
PROTOCOL_VARIANTS = ("rapid", "ring", "hier")

#: Fleet-campaign block embedded in a fleet run payload under
#: ``"campaign"`` (``rapid_tpu_torch.campaign.run_campaign``). Schema v8 adds
#: the replay identity (``n``/``ticks``/``headroom``/``weights``/
#: ``flight_recorder`` — together with ``seed``/``clusters``/
#: ``fleet_size``/``per_receiver.enabled`` they reconstruct every
#: sampled schedule and the dispatch plan bit-exactly, which is what
#: ``python -m rapid_tpu_torch.replay`` consumes) and the ``triage`` block.
#: Schema v11 adds ``protocol_variant`` (the wire protocol every member
#: ran — replay re-derives the variant from this field alone) and the
#: optional ``tournament`` block (present only on A/B tournament runs,
#: ``campaign.run_tournament``).
CAMPAIGN_SPEC = {
    "seed": (int,),
    "protocol_variant": (str,),
    "clusters": (int,),
    "n": (int,),
    "ticks": (int,),
    "headroom": (int,),
    "weights": (dict,),
    "flight_recorder": (int,),
    "fleet_size": (int,),
    "dispatches": (int,),
    "scenario_kinds": (dict,),
    "pools": (list,),
    "per_receiver": (dict,),
    "spot_checks": (dict,),
    "distributions": (dict,),
    "delay_regimes": (dict,),
    "triage": (dict,),
    "lineage": (dict,),
}

#: Anomaly classes of the campaign triage block (schema v8), in the
#: order ``campaign._triage`` reports them. Every class key must be
#: present in ``triage.classes`` even when its count is zero — absence
#: would be indistinguishable from "classifier never ran".
TRIAGE_CLASSES = ("no_decide_by_deadline", "slow_decide",
                  "invariant_violations", "envelope_flags",
                  "excess_fallback", "spot_failures")

#: Top-level ``campaign.triage`` block (schema v8). Every value is a
#: seed-deterministic fold — no wall-clock fields — so bench_compare's
#: exact campaign diff gates the whole block. ``recorder`` is null when
#: the campaign ran without ``--flight-recorder``.
TRIAGE_SPEC = {
    "clusters": (int,),
    "flagged_members": (int,),
    "thresholds": (dict,),
    "recorder": (dict, type(None)),
    "classes": (dict,),
}

#: One anomaly class: total flagged members, per-scenario-kind counts,
#: and up to ``campaign.MAX_TRIAGE_EXEMPLARS`` exemplar refs.
TRIAGE_CLASS_SPEC = {
    "count": (int,),
    "by_kind": (dict,),
    "exemplars": (list,),
}

#: One triage exemplar: the ``(dispatch, member_index)`` ref is the
#: ``--member D:I`` handle ``rapid_tpu_torch.replay`` takes; ``expected`` is
#: the bit-identity contract the replay must reproduce (null only for
#: forced spot-check schedules that never ran in the fleet, ref
#: ``(-1, -1)``); ``recorder`` is the member's extracted flight-recorder
#: ring (null when the campaign ran without one).
TRIAGE_EXEMPLAR_SPEC = {
    "dispatch": (int,),
    "member_index": (int,),
    "member": (int,),
    "kind": (str,),
    "mode": (str,),
    "seed": (int,),
    "expected": (dict, type(None)),
    "recorder": (dict, type(None)),
    # Schema v12: the member's lineage span list (null for forced
    # spot-check refs that never ran in the fleet).
    "lineage": (list, type(None)),
}

#: The exemplar ``expected`` block (``campaign._expected_block``): the
#: per-member fold fields a replay must match bit-for-bit.
TRIAGE_EXPECTED_SPEC = {
    "ticks_to_first_announce": _OPT_INT,
    "ticks_to_first_decide": _OPT_INT,
    "announcements": (int,),
    "decisions": (int,),
    "invariant_violations": (int,),
    "counter_totals": (dict,),
    "fallback_phase_sent": (dict,),
    "config_ids": (list,),
    "flags": (int,),
}

#: One kind-homogeneous dispatch pool of a campaign plan (schema v7):
#: members bucketed by shape signature before stacking, so padding is
#: per-pool-tight and each pool compiles one executable. ``shape`` is
#: the pool's stacking maxima in the padding key space
#: (DISPATCH_PADDING_SPEC keys).
CAMPAIGN_POOL_SPEC = {
    "pool_id": (int,),
    "mode": (str,),
    "members": (int,),
    "dispatches": (int,),
    "fleet_size": (int,),
    "kinds": (dict,),
    "shape": (dict,),
}

#: A/B tournament block (schema v11) under ``campaign.tournament``,
#: present only when the payload came from ``campaign.run_tournament``:
#: every sampled member ran once per listed variant over identical
#: schedules/identities. All fields are seed-deterministic, so
#: ``scripts/bench_compare.py``'s exact campaign diff gates the block.
TOURNAMENT_SPEC = {
    "variants": (list,),
    "clusters": (int,),
    "per_variant": (dict,),
    "win_loss": (dict,),
}

#: One per-variant tournament row: decide counts, classic-fallback
#: member count, total wire messages, and the nearest-rank
#: decide-tick tail (one DISTRIBUTION_SPEC block).
TOURNAMENT_VARIANT_SPEC = {
    "decided": (int,),
    "fallback_members": (int,),
    "total_messages": (int,),
    "decide_ticks": (dict,),
    # Schema v12: per-variant lineage summary — the phase-duration
    # tails that show *where* a variant pays its latency.
    "lineage": (dict,),
}

#: Delay-regime keys the ``delay_regimes`` block may carry (schema v6):
#: the latency-family scenario kinds plus the delay-free rest of the
#: campaign. Each value is one DISTRIBUTION_SPEC block over that
#: regime's per-member ticks-to-first-decide.
DELAY_REGIMES = ("delay", "jitter", "slow_asym", "no_delay")

#: Per-receiver dispatch block of a campaign payload (schema v4): how
#: many members ran device-exact under link faults and the measured
#: quadratic budget that gated them (``receiver.receiver_state_bytes``).
PER_RECEIVER_SPEC = {
    "enabled": (bool,),
    "members": (int,),
    "dispatches": (int,),
    "fleet_size": (int,),
    "capacity": (int,),
    "capacity_cap": (int,),
    "ring_depth": (int,),
    "member_state_bytes": (int,),
    "kinds": (dict,),
}

SPOT_CHECK_SPEC = {
    "requested": (int,),
    "run": (int,),
    "passed": (int,),
    "failed": (int,),
    "max_failures": (int,),
    "members": (list,),
}

#: One spot-check member record (schema v4 adds the graceful-degradation
#: fields: mode, pass/fail, forensics artifact path, first-line error).
SPOT_MEMBER_SPEC = {
    "member": (int,),
    "kind": (str,),
    "seed": (int,),
    "mode": (str,),
    "passed": (bool,),
    "artifact": (str, type(None)),
    "error": (str, type(None)),
}

#: Distribution keys every campaign payload must carry.
CAMPAIGN_DISTRIBUTIONS = ("ticks_to_first_decide", "total_sent",
                          "messages_per_view_change", "decisions")

#: The required ``campaign.lineage`` block: the fleet-wide summary plus
#: per-scenario-kind and per-delay-regime breakdowns (each value one
#: LINEAGE_SUMMARY_SPEC block).
CAMPAIGN_LINEAGE_SPEC = dict(LINEAGE_SUMMARY_SPEC,
                             by_kind=(dict,), by_regime=(dict,))

#: Per-dispatch stage keys of the campaign dispatch observatory (schema
#: v5), in pipeline order. ``sample``/``lower`` are the host costs
#: attributed to the dispatch's members, ``stack`` the padding+stack of
#: the batched pytree, ``compile`` the one-time work of a pool's first
#: dispatch (0.0 on later dispatches of the pool; in the port the kernel
#: build and the boot caches), ``execute`` the fenced device dispatch,
#: ``fold`` the per-member summary fold.
DISPATCH_STAGES = ("sample", "lower", "stack", "compile", "execute",
                   "fold")

#: One ``dispatch_timeline`` record (schema v5). ``wall_s`` is the sum
#: of the stage walls by construction; ``clusters_per_sec`` is null when
#: the dispatch wall is below the measurable floor. ``host_blocked_frac``
#: is the fraction of the dispatch wall the host spent off-device
#: (everything but ``execute``) — the per-dispatch double-buffering
#: headroom signal.
DISPATCH_RECORD_SPEC = {
    "index": (int,),
    "mode": (str,),
    "pool_id": (int,),
    "pool_shape": (dict,),
    "members": (int,),
    "pad_members": (int,),
    "fleet_size": (int,),
    "kinds": (dict,),
    "compiled": (bool,),
    "stages": (dict,),
    "wall_s": _NUM,
    "clusters_per_sec": (int, float, type(None)),
    "host_blocked_frac": (int, float, type(None)),
    "padding": (dict,),
    "memory": (dict,),
}

#: Padding waste of one dispatch: inert rows added by ``stack_members``
#: / ``stack_receiver_members`` to reach the campaign-global maxima
#: (link-window rows, fallback instance rows, fallback pid rows,
#: provably-inert delay rules), summed over the fleet axis.
DISPATCH_PADDING_SPEC = {
    "window_rows": (int,),
    "fallback_instances": (int,),
    "fallback_pids": (int,),
    "delay_rules": (int,),
}

#: Device-memory watermark after one dispatch. ``live_buffer_bytes`` is
#: ``torch.cuda.memory_allocated()`` (process-wide, so it is a watermark,
#: not an attribution; 0 on the CPU); ``device_peak_bytes`` is
#: ``torch.cuda.max_memory_allocated()`` and null on the CPU.
DISPATCH_MEMORY_SPEC = {
    "live_buffer_bytes": (int,),
    "device_peak_bytes": _OPT_INT,
}

#: One compile record of a pool's first dispatch. The reference fills it
#: from its ahead-of-time compile and XLA's memory analysis; the port
#: compiles nothing ahead of time, so ``lower_s`` is 0.0, ``compile_s``
#: the dispatch's one-time work, ``argument_bytes`` the stacked fleet's
#: tensor bytes, ``output_bytes`` those of its finals, logs and recorder,
#: and ``peak_bytes``/``temp_bytes`` come from
#: ``torch.cuda.max_memory_allocated`` over the dispatch (0 on the CPU).
AOT_COMPILE_SPEC = {
    "lower_s": _NUM,
    "compile_s": _NUM,
    "argument_bytes": (int,),
    "output_bytes": (int,),
    "temp_bytes": (int,),
    "peak_bytes": (int,),
}

#: Top-level ``observatory`` block of a campaign payload (schema v5):
#: where the campaign wall actually went. ``device_busy_s`` is the
#: fenced execute total, ``compile_s`` the one-time compile cost,
#: ``host_blocked_s`` everything else (sample/lower/stack/fold/glue);
#: ``overlap_headroom_s`` = min(host_blocked_s, device_busy_s) is the
#: wall a perfect double-buffer could hide. ``compile`` carries one
#: AOT_COMPILE_SPEC record per dispatch mode (null when the mode never
#: dispatched).
OBSERVATORY_SPEC = {
    "host_blocked_s": _NUM,
    "device_busy_s": _NUM,
    "compile_s": _NUM,
    "host_blocked_frac": (int, float, type(None)),
    "device_busy_frac": (int, float, type(None)),
    "overlap_headroom_s": _NUM,
    "min_measurable_wall_s": _NUM,
    "compile": (dict,),
    "pipeline": (dict,),
}

#: Dispatch-pipeline block of the observatory (schema v7): whether the
#: double-buffered loop ran, its configured in-flight depth, and the
#: depth it actually reached (``peak_in_flight == 1`` under
#: ``--no-pipeline`` or when the plan has a single dispatch).
PIPELINE_SPEC = {
    "enabled": (bool,),
    "max_in_flight": (int,),
    "peak_in_flight": (int,),
}

#: One ``record: "dispatch"`` heartbeat line of a ``--progress`` JSONL
#: stream (schema v7 adds the pool identity and the live pipeline
#: depth *after* this dispatch retired; schema v8 adds ``anomalies`` —
#: the running per-class anomaly counts over the members retired so
#: far, so a long campaign's heartbeats show trouble as it accumulates,
#: not at the final fold).
PROGRESS_DISPATCH_SPEC = {
    "record": (str,),
    "index": (int,),
    "mode": (str,),
    "pool_id": (int,),
    "pool_shape": (dict,),
    "in_flight_dispatches": (int,),
    "clusters_done": (int,),
    "clusters_total": (int,),
    "stages": (dict,),
    "spot_failures": (int,),
    "anomalies": (dict,),
    # Schema v9: per-dispatch throughput, same null-below-the-floor rate
    # convention as the streaming records.
    "ticks_per_sec": (int, float, type(None)),
    "events_per_sec": (int, float, type(None)),
}

#: Relative slack allowed between a campaign payload's ``wall_s`` and
#: the sum of its per-dispatch stage walls (timer granularity + loop
#: glue); only enforced once the wall is comfortably measurable. The
#: floor sits at a quarter second: with memoized boot state (schema v7)
#: a micro-campaign's true stage work is a few tens of milliseconds, so
#: below this floor loop glue — not instrumentation drift — dominates
#: the residual.
STAGE_SUM_TOLERANCE = 0.10
_STAGE_SUM_MIN_WALL_S = 0.25


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


def validate_campaign_lineage(block, where: str = "campaign.lineage"
                              ) -> List[str]:
    """Validate the required ``campaign.lineage`` block: the fleet-wide
    summary plus ``by_kind``/``by_regime`` breakdown summaries."""
    errors = validate_lineage_summary(block, where)
    if not isinstance(block, dict):
        return errors
    errors += _check(block, {"by_kind": (dict,), "by_regime": (dict,)},
                     where)
    for group in ("by_kind", "by_regime"):
        sub = block.get(group)
        if not isinstance(sub, dict):
            continue
        for key, summary in sub.items():
            errors += validate_lineage_summary(summary,
                                               f"{where}.{group}.{key}")
        if group == "by_regime":
            for key in sub:
                if key not in DELAY_REGIMES:
                    errors.append(f"{where}.by_regime.{key}: unknown "
                                  f"regime (expected one of "
                                  f"{'/'.join(DELAY_REGIMES)})")
    return errors


def validate_triage(block, where: str = "triage") -> List[str]:
    """Validate a campaign ``triage`` block (schema v8)."""
    errors = _check(block, TRIAGE_SPEC, where)
    if not isinstance(block, dict):
        return errors
    classes = block.get("classes")
    if not isinstance(classes, dict):
        return errors
    for name in TRIAGE_CLASSES:
        if name not in classes:
            errors.append(f"{where}.classes.{name}: missing")
    for name, cls in classes.items():
        cw = f"{where}.classes.{name}"
        if name not in TRIAGE_CLASSES:
            errors.append(f"{cw}: unknown class (expected one of "
                          f"{'/'.join(TRIAGE_CLASSES)})")
        errors += _check(cls, TRIAGE_CLASS_SPEC, cw)
        if not isinstance(cls, dict):
            continue
        for i, ex in enumerate(cls.get("exemplars") or []):
            ew = f"{cw}.exemplars[{i}]"
            errors += _check(ex, TRIAGE_EXEMPLAR_SPEC, ew)
            if not isinstance(ex, dict):
                continue
            if isinstance(ex.get("expected"), dict):
                errors += _check(ex["expected"], TRIAGE_EXPECTED_SPEC,
                                 f"{ew}.expected")
            if isinstance(ex.get("recorder"), dict):
                errors += validate_flight_recorder(ex["recorder"],
                                                   f"{ew}.recorder")
            if isinstance(ex.get("lineage"), list):
                for j, span in enumerate(ex["lineage"]):
                    errors += validate_lineage_span(
                        span, f"{ew}.lineage[{j}]")
    return errors


def validate_tournament(block, where: str = "tournament") -> List[str]:
    """Validate one ``campaign.tournament`` A/B block (schema v11)."""
    errors = _check(block, TOURNAMENT_SPEC, where)
    if not isinstance(block, dict):
        return errors
    raw = block.get("variants")
    names = [v for v in raw if isinstance(v, str)] \
        if isinstance(raw, list) else []
    for v in names:
        if v not in PROTOCOL_VARIANTS:
            errors.append(f"{where}.variants: {v!r} is not one of "
                          f"{'/'.join(PROTOCOL_VARIANTS)}")
    per = block.get("per_variant")
    if isinstance(per, dict):
        for v in names:
            if v not in per:
                errors.append(f"{where}.per_variant.{v}: missing")
        for v, row in per.items():
            vw = f"{where}.per_variant.{v}"
            if v not in names:
                errors.append(f"{vw}: names no tournament variant")
            errors += _check(row, TOURNAMENT_VARIANT_SPEC, vw)
            if isinstance(row, dict) \
                    and isinstance(row.get("decide_ticks"), dict):
                errors += _check(row["decide_ticks"], DISTRIBUTION_SPEC,
                                 f"{vw}.decide_ticks")
            if isinstance(row, dict) \
                    and isinstance(row.get("lineage"), dict):
                errors += validate_lineage_summary(row["lineage"],
                                                   f"{vw}.lineage")
    wl = block.get("win_loss")
    if isinstance(wl, dict):
        for kind, row in wl.items():
            kw = f"{where}.win_loss.{kind}"
            if not isinstance(row, dict):
                errors.append(f"{kw}: expected an object, "
                              f"got {type(row).__name__}")
                continue
            for key in names + ["tie"]:
                if key not in row:
                    errors.append(f"{kw}.{key}: missing")
            for key, count in row.items():
                if not isinstance(count, int) or isinstance(count, bool):
                    errors.append(f"{kw}.{key}: expected int, "
                                  f"got {type(count).__name__}")
    return errors


def validate_campaign(block, where: str = "campaign") -> List[str]:
    errors = _check(block, CAMPAIGN_SPEC, where)
    if not isinstance(block, dict):
        return errors
    pv = block.get("protocol_variant")
    if isinstance(pv, str) and pv not in PROTOCOL_VARIANTS:
        errors.append(f"{where}.protocol_variant: {pv!r} is not one of "
                      f"{'/'.join(PROTOCOL_VARIANTS)}")
    if "tournament" in block:
        errors += validate_tournament(block["tournament"],
                                      f"{where}.tournament")
    kinds = block.get("scenario_kinds")
    if isinstance(kinds, dict):
        for kind, count in kinds.items():
            if not isinstance(count, int) or isinstance(count, bool):
                errors.append(f"{where}.scenario_kinds.{kind}: expected "
                              f"int, got {type(count).__name__}")
    pools = block.get("pools")
    if isinstance(pools, list):
        for i, pool in enumerate(pools):
            pw = f"{where}.pools[{i}]"
            errors += _check(pool, CAMPAIGN_POOL_SPEC, pw)
            if not isinstance(pool, dict):
                continue
            if isinstance(pool.get("pool_id"), int) \
                    and pool["pool_id"] != i:
                errors.append(f"{pw}.pool_id: expected {i}, "
                              f"got {pool['pool_id']}")
            if pool.get("mode") not in ("shared", "per_receiver", None):
                errors.append(f"{pw}.mode: expected 'shared' or "
                              f"'per_receiver', got {pool['mode']!r}")
            if isinstance(pool.get("shape"), dict):
                errors += _check(pool["shape"], DISPATCH_PADDING_SPEC,
                                 f"{pw}.shape")
    if isinstance(block.get("per_receiver"), dict):
        errors += _check(block["per_receiver"], PER_RECEIVER_SPEC,
                         f"{where}.per_receiver")
    if isinstance(block.get("spot_checks"), dict):
        errors += _check(block["spot_checks"], SPOT_CHECK_SPEC,
                         f"{where}.spot_checks")
        for i, m in enumerate(block["spot_checks"].get("members") or []):
            errors += _check(m, SPOT_MEMBER_SPEC,
                             f"{where}.spot_checks.members[{i}]")
    dists = block.get("distributions")
    if isinstance(dists, dict):
        for key in CAMPAIGN_DISTRIBUTIONS:
            if key not in dists:
                errors.append(f"{where}.distributions.{key}: missing")
            else:
                errors += _check(dists[key], DISTRIBUTION_SPEC,
                                 f"{where}.distributions.{key}")
    regimes = block.get("delay_regimes")
    if isinstance(regimes, dict):
        for key, dist in regimes.items():
            if key not in DELAY_REGIMES:
                errors.append(f"{where}.delay_regimes.{key}: unknown "
                              f"regime (expected one of "
                              f"{'/'.join(DELAY_REGIMES)})")
            errors += _check(dist, DISTRIBUTION_SPEC,
                             f"{where}.delay_regimes.{key}")
    if "triage" in block:
        errors += validate_triage(block["triage"], f"{where}.triage")
    if isinstance(block.get("lineage"), dict):
        errors += validate_campaign_lineage(block["lineage"],
                                            f"{where}.lineage")
    return errors


def validate_dispatch_timeline(timeline, where: str = "dispatch_timeline"
                               ) -> List[str]:
    """Validate one campaign's per-dispatch timeline (schema v5)."""
    errors: List[str] = []
    if not isinstance(timeline, list):
        return [f"{where}: expected a list, "
                f"got {type(timeline).__name__}"]
    for i, rec in enumerate(timeline):
        rw = f"{where}[{i}]"
        errors += _check(rec, DISPATCH_RECORD_SPEC, rw)
        if not isinstance(rec, dict):
            continue
        if isinstance(rec.get("index"), int) and rec["index"] != i:
            errors.append(f"{rw}.index: expected {i}, got {rec['index']}")
        if rec.get("mode") not in ("shared", "per_receiver", None):
            errors.append(f"{rw}.mode: expected 'shared' or "
                          f"'per_receiver', got {rec['mode']!r}")
        stages = rec.get("stages")
        if isinstance(stages, dict):
            errors += _check(stages,
                             {s: _NUM for s in DISPATCH_STAGES},
                             f"{rw}.stages")
            extra = set(stages) - set(DISPATCH_STAGES)
            for s in sorted(extra):
                errors.append(f"{rw}.stages.{s}: unknown stage")
        if isinstance(rec.get("padding"), dict):
            errors += _check(rec["padding"], DISPATCH_PADDING_SPEC,
                             f"{rw}.padding")
        if isinstance(rec.get("pool_shape"), dict):
            errors += _check(rec["pool_shape"], DISPATCH_PADDING_SPEC,
                             f"{rw}.pool_shape")
        if isinstance(rec.get("memory"), dict):
            errors += _check(rec["memory"], DISPATCH_MEMORY_SPEC,
                             f"{rw}.memory")
    return errors


def validate_observatory(block, where: str = "observatory") -> List[str]:
    errors = _check(block, OBSERVATORY_SPEC, where)
    if not isinstance(block, dict):
        return errors
    compile_block = block.get("compile")
    if isinstance(compile_block, dict):
        for mode in ("shared", "per_receiver"):
            if mode not in compile_block:
                errors.append(f"{where}.compile.{mode}: missing")
                continue
            entry = compile_block[mode]
            if entry is not None:  # null == that mode never dispatched
                errors += _check(entry, AOT_COMPILE_SPEC,
                                 f"{where}.compile.{mode}")
        # Schema v7: the per-pool compile ledger — one record per
        # (mode, shape-bucket) executable the campaign actually built.
        pools = compile_block.get("pools")
        if pools is None:
            errors.append(f"{where}.compile.pools: missing")
        elif not isinstance(pools, list):
            errors.append(f"{where}.compile.pools: expected list, "
                          f"got {type(pools).__name__}")
        else:
            for i, entry in enumerate(pools):
                errors += _check(entry, dict(AOT_COMPILE_SPEC,
                                             pool_id=(int,), mode=(str,)),
                                 f"{where}.compile.pools[{i}]")
    pipeline = block.get("pipeline")
    if isinstance(pipeline, dict):
        errors += _check(pipeline, PIPELINE_SPEC, f"{where}.pipeline")
    return errors


def validate_progress_stream(lines, where: str = "progress") -> List[str]:
    """Validate the ``record: "dispatch"`` lines of a ``--progress``
    JSONL heartbeat stream (schema v7). Non-dispatch records (campaign
    summary, spot checks) pass through unchecked — their shapes belong
    to their own producers."""
    errors: List[str] = []
    saw_dispatch = False
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            errors.append(f"{where}[{i}]: not JSON ({e})")
            continue
        if not isinstance(rec, dict) or rec.get("record") != "dispatch":
            continue
        saw_dispatch = True
        rw = f"{where}[{i}]"
        errors += _check(rec, PROGRESS_DISPATCH_SPEC, rw)
        if isinstance(rec.get("pool_shape"), dict):
            errors += _check(rec["pool_shape"], DISPATCH_PADDING_SPEC,
                             f"{rw}.pool_shape")
        if isinstance(rec.get("stages"), dict):
            errors += _check(rec["stages"],
                             {s: _NUM for s in DISPATCH_STAGES},
                             f"{rw}.stages")
        anomalies = rec.get("anomalies")
        if isinstance(anomalies, dict):
            for name, count in anomalies.items():
                if name not in TRIAGE_CLASSES:
                    errors.append(f"{rw}.anomalies.{name}: unknown "
                                  f"triage class")
                if not isinstance(count, int) or isinstance(count, bool):
                    errors.append(f"{rw}.anomalies.{name}: expected int, "
                                  f"got {type(count).__name__}")
    if not saw_dispatch:
        errors.append(f"{where}: no dispatch heartbeat records")
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


def validate_servo_summary(block, where: str = "servo") -> List[str]:
    """Validate a summary ``servo`` block ({"config", "final"})."""
    errors: List[str] = []
    if not isinstance(block, dict):
        return [f"{where}: expected an object, got {type(block).__name__}"]
    errors += _check(block.get("config"), SERVO_CONFIG_SPEC,
                     f"{where}.config")
    errors += _check(block.get("final"), SERVO_CHUNK_SPEC,
                     f"{where}.final")
    return errors


def validate_stream_chunk(rec, where: str = "chunk") -> List[str]:
    """Validate one ``record: "chunk"`` resident heartbeat."""
    errors = _check(rec, STREAM_CHUNK_SPEC, where)
    if not isinstance(rec, dict):
        return errors
    if isinstance(rec.get("traffic"), dict):
        errors += _check(rec["traffic"], STREAM_TRAFFIC_INFO_SPEC,
                         f"{where}.traffic")
    if isinstance(rec.get("servo"), dict):
        errors += _check(rec["servo"], SERVO_CHUNK_SPEC, f"{where}.servo")
    if isinstance(rec.get("slo"), dict):
        errors += validate_slo_window(rec["slo"], f"{where}.slo")
    if isinstance(rec.get("lineage"), dict):
        errors += validate_lineage_summary(rec["lineage"],
                                           f"{where}.lineage")
    if isinstance(rec.get("checkpoint"), dict):
        errors += _check(rec["checkpoint"], STREAM_CHECKPOINT_SPEC,
                         f"{where}.checkpoint")
    return errors


def validate_stream_summary(rec, where: str = "stream_summary"
                            ) -> List[str]:
    """Validate the final ``record: "stream_summary"`` line."""
    errors = _check(rec, STREAM_SUMMARY_SPEC, where)
    if not isinstance(rec, dict):
        return errors
    errors += _version_errors(rec)
    if isinstance(rec.get("ticks_to_view_change"), dict):
        errors += _check(rec["ticks_to_view_change"], DISTRIBUTION_SPEC,
                         f"{where}.ticks_to_view_change")
    if isinstance(rec.get("live_buffer_bytes"), dict):
        errors += _check(rec["live_buffer_bytes"], STREAM_WATERMARK_SPEC,
                         f"{where}.live_buffer_bytes")
    if isinstance(rec.get("traffic"), dict):
        errors += _check(rec["traffic"], TRAFFIC_CONFIG_SPEC,
                         f"{where}.traffic")
    if isinstance(rec.get("servo"), dict):
        errors += validate_servo_summary(rec["servo"], f"{where}.servo")
    if isinstance(rec.get("slo"), dict):
        errors += validate_slo_window(rec["slo"], f"{where}.slo")
    if isinstance(rec.get("lineage"), dict):
        errors += validate_lineage_summary(rec["lineage"],
                                           f"{where}.lineage")
    if isinstance(rec.get("checkpoint"), dict):
        errors += _check(rec["checkpoint"], STREAM_CHECKPOINT_SPEC,
                         f"{where}.checkpoint")
    return errors


def validate_status_snapshot(rec, where: str = "status") -> List[str]:
    """Validate one live ``record: "status_snapshot"`` line (schema
    v10) — the status file's content and every socket reply."""
    errors = _check(rec, STATUS_SNAPSHOT_SPEC, where)
    if not isinstance(rec, dict):
        return errors
    errors += _version_errors(rec)
    if rec.get("record") != "status_snapshot":
        errors.append(f"{where}.record: expected 'status_snapshot', "
                      f"got {rec.get('record')!r}")
    if isinstance(rec.get("servo"), dict):
        errors += _check(rec["servo"], SERVO_CHUNK_SPEC, f"{where}.servo")
    if isinstance(rec.get("slo"), dict):
        errors += validate_slo_window(rec["slo"], f"{where}.slo")
    if isinstance(rec.get("lineage"), dict):
        errors += validate_lineage_summary(rec["lineage"],
                                           f"{where}.lineage")
    if isinstance(rec.get("checkpoint"), dict):
        errors += _check(rec["checkpoint"], STREAM_CHECKPOINT_SPEC,
                         f"{where}.checkpoint")
    return errors


def validate_load_sweep(payload, where: str = "load_sweep") -> List[str]:
    """Validate a ``record: "load_sweep"`` saturation-sweep artifact:
    one rate entry per target (in target order), each with a schema-
    valid servo config and SLO window, and a knee consistent with the
    stability verdicts (the largest stable target, or null)."""
    errors = _check(payload, LOAD_SWEEP_SPEC, where)
    if not isinstance(payload, dict):
        return errors
    errors += _version_errors(payload)
    if payload.get("record") != "load_sweep":
        errors.append(f"{where}.record: expected 'load_sweep', "
                      f"got {payload.get('record')!r}")
    targets = payload.get("targets")
    rates = payload.get("rates")
    if isinstance(targets, list) and isinstance(rates, list) \
            and len(targets) != len(rates):
        errors.append(f"{where}.rates: {len(rates)} entries for "
                      f"{len(targets)} targets")
    best_stable = None
    if isinstance(rates, list):
        for i, rate in enumerate(rates):
            rw = f"{where}.rates[{i}]"
            errors += _check(rate, LOAD_SWEEP_RATE_SPEC, rw)
            if not isinstance(rate, dict):
                continue
            if isinstance(targets, list) and i < len(targets) \
                    and rate.get("target_events_per_sec") != targets[i]:
                errors.append(
                    f"{rw}.target_events_per_sec: expected "
                    f"{targets[i]!r}, got "
                    f"{rate.get('target_events_per_sec')!r}")
            if isinstance(rate.get("servo_config"), dict):
                errors += _check(rate["servo_config"], SERVO_CONFIG_SPEC,
                                 f"{rw}.servo_config")
            if isinstance(rate.get("slo"), dict):
                errors += validate_slo_window(rate["slo"], f"{rw}.slo")
            if rate.get("stable") is True and isinstance(
                    rate.get("target_events_per_sec"), (int, float)):
                t = rate["target_events_per_sec"]
                if best_stable is None or t > best_stable:
                    best_stable = t
    knee = payload.get("knee")
    if isinstance(knee, dict):
        errors += _check(knee, LOAD_SWEEP_KNEE_SPEC, f"{where}.knee")
        if knee.get("target_events_per_sec") != best_stable:
            errors.append(
                f"{where}.knee.target_events_per_sec: expected the "
                f"largest stable target ({best_stable!r}), got "
                f"{knee.get('target_events_per_sec')!r}")
    elif knee is None and best_stable is not None:
        errors.append(f"{where}.knee: null despite stable targets "
                      f"(largest: {best_stable!r})")
    return errors


def validate_checkpoint_manifest(manifest, where: str = "manifest"
                                 ) -> List[str]:
    """Validate a ``service.checkpoint`` ``manifest.json`` payload
    (structure only — version/statics *compatibility* is the loader's
    job and raises typed errors there)."""
    errors = _check(manifest, CHECKPOINT_MANIFEST_SPEC, where)
    if not isinstance(manifest, dict):
        return errors
    for i, leaf in enumerate(manifest.get("leaves") or []):
        errors += _check(leaf, CHECKPOINT_LEAF_SPEC, f"{where}.leaves[{i}]")
    return errors


def validate_streaming_stream(lines, where: str = "stream") -> List[str]:
    """Validate a resident-engine JSONL metrics stream: every
    ``record: "chunk"`` heartbeat, exactly one trailing
    ``record: "stream_summary"`` line. Tick rows (no ``record`` key)
    pass through unchecked — their shape is ``TickMetrics.as_dict`` and
    belongs to the metrics producer."""
    errors: List[str] = []
    chunks = 0
    summaries = 0
    last_kind = None
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            errors.append(f"{where}[{i}]: not JSON ({e})")
            continue
        if not isinstance(rec, dict):
            errors.append(f"{where}[{i}]: expected an object")
            continue
        kind = rec.get("record")
        last_kind = kind
        if kind == "chunk":
            chunks += 1
            errors += validate_stream_chunk(rec, f"{where}[{i}]")
        elif kind == "stream_summary":
            summaries += 1
            errors += validate_stream_summary(rec, f"{where}[{i}]")
    if chunks == 0:
        errors.append(f"{where}: no chunk heartbeat records")
    if summaries != 1:
        errors.append(f"{where}: expected exactly one stream_summary "
                      f"record, found {summaries}")
    elif last_kind != "stream_summary":
        errors.append(f"{where}: stream_summary must be the final record")
    return errors


#: Extra required fields of the ``scenario: "streaming"`` bench run
#: (schema v9) on top of ``RUN_SPEC``.
STREAMING_RUN_SPEC = {
    "scenario": (str,),
    "capacity": (int,),
    "chunk_ticks": (int,),
    "chunks": (int,),
    "events_injected": (int,),
    "events_per_sec": (int, float, type(None)),
    "traffic": (dict,),
    "ticks_to_view_change": (dict,),
    # Schema v12: whole-run lineage summary.
    "lineage": (dict, type(None)),
    "checkpoint": (dict, type(None)),
}


def validate_run_payload(payload, where: str = "payload") -> List[str]:
    """One single-run bench payload: ``RUN_SPEC`` and its telemetry
    block, and for a campaign payload its ``campaign`` block, dispatch
    timeline and observatory with the stage-sum check, and for a
    streaming payload its traffic, view-change, lineage and checkpoint
    blocks."""
    errors = _check(payload, RUN_SPEC, where)
    if isinstance(payload, dict) and isinstance(payload.get("telemetry"),
                                                dict):
        errors += validate_telemetry(payload["telemetry"],
                                     f"{where}.telemetry")
    if isinstance(payload, dict) and payload.get("scenario") == "streaming":
        errors += _check(payload, STREAMING_RUN_SPEC, where)
        if isinstance(payload.get("traffic"), dict):
            errors += _check(payload["traffic"], TRAFFIC_CONFIG_SPEC,
                             f"{where}.traffic")
        if isinstance(payload.get("ticks_to_view_change"), dict):
            errors += _check(payload["ticks_to_view_change"],
                             DISTRIBUTION_SPEC,
                             f"{where}.ticks_to_view_change")
        if isinstance(payload.get("lineage"), dict):
            errors += validate_lineage_summary(payload["lineage"],
                                               f"{where}.lineage")
        if isinstance(payload.get("checkpoint"), dict):
            errors += _check(payload["checkpoint"], STREAM_CHECKPOINT_SPEC,
                             f"{where}.checkpoint")
    if isinstance(payload, dict) and "campaign" in payload:
        errors += validate_campaign(payload["campaign"], f"{where}.campaign")
        # Schema v5: a campaign payload must carry the dispatch
        # observatory — the per-dispatch timeline, the host/device wall
        # accounting, and the fleet throughput figure.
        for key, types in (("dispatch_timeline", (list,)),
                           ("observatory", (dict,)),
                           ("clusters_per_sec", (int, float, type(None)))):
            if key not in payload:
                errors.append(f"{where}.{key}: missing")
            elif not isinstance(payload[key], types):
                errors.append(f"{where}.{key}: expected "
                              f"{'/'.join(t.__name__ for t in types)}, "
                              f"got {type(payload[key]).__name__}")
        errors += validate_dispatch_timeline(
            payload.get("dispatch_timeline") or [],
            f"{where}.dispatch_timeline")
        if isinstance(payload.get("observatory"), dict):
            errors += validate_observatory(payload["observatory"],
                                           f"{where}.observatory")
        # Semantic cross-check: the per-stage walls must account for the
        # campaign wall (within tolerance) — a timeline that doesn't sum
        # to the wall it claims to explain is instrumentation drift.
        wall = payload.get("wall_s")
        timeline = payload.get("dispatch_timeline")
        if isinstance(wall, (int, float)) and not isinstance(wall, bool) \
                and isinstance(timeline, list) \
                and wall >= _STAGE_SUM_MIN_WALL_S:
            stage_sum = 0.0
            for rec in timeline:
                if isinstance(rec, dict) and isinstance(rec.get("stages"),
                                                        dict):
                    stage_sum += sum(
                        v for v in rec["stages"].values()
                        if isinstance(v, (int, float))
                        and not isinstance(v, bool))
            if abs(wall - stage_sum) > STAGE_SUM_TOLERANCE * wall:
                errors.append(
                    f"{where}.dispatch_timeline: stage walls sum to "
                    f"{stage_sum:.3f}s, outside ±"
                    f"{STAGE_SUM_TOLERANCE * 100:.0f}% of wall_s={wall:.3f}s")
    return errors


def validate_profile_payload(payload, where: str = "payload") -> List[str]:
    """Validate a ``kernel_profile_sweep`` dominance report."""
    errors = _check(payload, PROFILE_SWEEP_SPEC, where)
    if not isinstance(payload, dict):
        return errors
    for i, run in enumerate(payload.get("runs") or []):
        rw = f"{where}.runs[{i}]"
        errors += _check(run, PROFILE_RUN_SPEC, rw)
        if not isinstance(run, dict):
            continue
        names = set()
        for j, kc in enumerate(run.get("kernels") or []):
            errors += _check(kc, KERNEL_COST_SPEC, f"{rw}.kernels[{j}]")
            if isinstance(kc, dict) and isinstance(kc.get("kernel"), str):
                names.add(kc["kernel"])
        dom = run.get("dominant")
        if isinstance(dom, dict):
            for axis, kernel in dom.items():
                if kernel not in names:
                    errors.append(f"{rw}.dominant.{axis}: {kernel!r} "
                                  f"names no profiled kernel")
    dom_by_n = payload.get("dominant_by_n")
    if isinstance(dom_by_n, dict):
        for n, kernel in dom_by_n.items():
            if not isinstance(kernel, str):
                errors.append(f"{where}.dominant_by_n[{n}]: expected str, "
                              f"got {type(kernel).__name__}")
    mc = payload.get("multichip")
    if mc is not None:  # null means "not measured", which is valid
        errors += _check(mc, MULTICHIP_SPEC, f"{where}.multichip")
        if isinstance(mc, dict):
            for j, entry in enumerate(mc.get("kernels") or []):
                errors += _check(entry, MULTICHIP_ENTRY_SPEC,
                                 f"{where}.multichip.kernels[{j}]")
    rm = payload.get("receiver_memory")
    if rm is not None:  # null means "not measured", which is valid
        errors += _check(rm, RECEIVER_MEMORY_SPEC,
                         f"{where}.receiver_memory")
        if isinstance(rm, dict):
            for j, entry in enumerate(rm.get("fleets") or []):
                errors += _check(entry, RECEIVER_FLEET_ENTRY_SPEC,
                                 f"{where}.receiver_memory.fleets[{j}]")
    vb = payload.get("variants")
    if vb is not None:  # null means "not measured", which is valid
        errors += _check(vb, VARIANT_SPEC, f"{where}.variants")
        if isinstance(vb, dict):
            for j, kc in enumerate(vb.get("kernels") or []):
                errors += _check(kc, VARIANT_KERNEL_SPEC,
                                 f"{where}.variants.kernels[{j}]")
            for j, rf in enumerate(vb.get("refusals") or []):
                errors += _check(rf, VARIANT_REFUSAL_SPEC,
                                 f"{where}.variants.refusals[{j}]")
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
    """Validate a single-run, sweep, suite or kernel-profile payload.
    Top-level payloads must carry a matching ``schema_version``."""
    if not isinstance(payload, dict):
        return ["payload: expected a JSON object"]
    errors = _version_errors(payload)
    if payload.get("bench") == "kernel_profile_sweep":
        return errors + validate_profile_payload(payload)
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


def _report(errors: List[str], ok: str) -> int:
    if errors:
        for e in errors:
            print(f"schema violation: {e}", file=sys.stderr)
        return 1
    print(ok)
    return 0


def main(argv=None) -> int:
    """The reference's schema CLI, with its messages and exit codes."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] in ("--progress", "--streaming"):
        validate = (validate_progress_stream if argv[0] == "--progress"
                    else validate_streaming_stream)
        with open(argv[1], "r", encoding="utf-8") as fh:
            errors = validate(fh.readlines())
        return _report(errors, f"{argv[0][2:]} schema ok: {argv[1]}")
    if len(argv) == 2 and argv[0] in ("--load-sweep", "--status"):
        with open(argv[1], "rb") as fh:
            raw = fh.read()
        errors = [] if raw.endswith(b"\n") else \
            ["payload: file must end with a trailing newline"]
        try:
            payload = json.loads(raw)
        except ValueError as e:
            errors.append(f"payload: not JSON ({e})")
            payload = None
        if payload is not None:
            validate = (validate_load_sweep if argv[0] == "--load-sweep"
                        else validate_status_snapshot)
            errors += validate(payload)
        return _report(errors, f"{argv[0][2:]} schema ok: {argv[1]}")
    if len(argv) != 1:
        print("usage: python -m rapid_tpu_torch.telemetry.schema "
              "[--progress|--streaming|--load-sweep|--status] FILE",
              file=sys.stderr)
        return 2
    with open(argv[0], "rb") as fh:
        raw = fh.read()
    # Every JSON artifact is a line-oriented build product: tools that
    # append or concatenate them rely on the trailing newline.
    errors = [] if raw.endswith(b"\n") else \
        ["payload: file must end with a trailing newline"]
    payload = json.loads(raw)
    errors += validate_bench_payload(payload)
    return _report(errors, f"telemetry schema ok: {argv[0]} "
                           f"({payload.get('bench', '?')})")


if __name__ == "__main__":
    raise SystemExit(main())
