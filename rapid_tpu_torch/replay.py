"""Deterministic single-member replay of a campaign member.

Own copy of the reference's ``replay.py``. Given only a campaign payload
(of either package: the campaign block is the same), it rebuilds the
sampled schedules, the pools and the dispatch plan from the campaign
seed (``campaign._plan``), re-runs one member as a fleet of one stacked
to its pool's shape, so the member's padded program is the one its
dispatch ran, and returns what the in-fleet fold threw away: the full
per-tick ``TickMetrics`` (``--metrics`` JSONL), a Perfetto trace of a
shared member's virtual time (``--trace``), the member's flight-recorder
ring, its lineage spans (``--lineage``) and a host referee differential
(``--oracle``, with ``--forensics`` naming the divergence JSONL).

When the member is a triage exemplar the replay is verified: every field
of the exemplar's ``expected`` block, its recorder ring and (with
``--lineage``) its spans must equal the fresh fold (exit 1 otherwise).

CLI (runs on the card unless ``--device cpu``)::

    python -m rapid_tpu_torch.replay --payload benchmarks/campaign_4096.json \\
        --member 7:58 --metrics member.jsonl --oracle
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Tuple

__all__ = ["replay_member", "main"]


def _find_exemplar(payload: Dict[str, object], dispatch: int,
                   member_index: int) -> Tuple[Optional[str],
                                               Optional[Dict[str, object]]]:
    """The triage exemplar for (dispatch, member_index), if the campaign
    flagged this member: (class_name, exemplar)."""
    triage = (payload.get("campaign") or {}).get("triage") or {}
    for name, block in (triage.get("classes") or {}).items():
        for ex in block.get("exemplars", ()):
            if (ex.get("dispatch") == dispatch
                    and ex.get("member_index") == member_index
                    and ex.get("expected") is not None):
                return name, ex
    return None, None


def _diff_blocks(expected: Dict[str, object], replayed: Dict[str, object]
                 ) -> Dict[str, Dict[str, object]]:
    """Field-by-field mismatches between the exemplar's expected block
    and the fresh fold ({} when equal)."""
    out: Dict[str, Dict[str, object]] = {}
    for key in sorted(set(expected) | set(replayed)):
        if expected.get(key) != replayed.get(key):
            out[key] = {"expected": expected.get(key),
                        "replayed": replayed.get(key)}
    return out


def replay_member(payload: Dict[str, object], dispatch: int,
                  member_index: int, *, oracle: bool = False,
                  lineage: bool = False,
                  metrics_path: Optional[str] = None,
                  trace_path: Optional[str] = None,
                  forensics_path: Optional[str] = None,
                  device="cuda") -> Dict[str, object]:
    """Re-run one campaign member on ``device`` from the payload's
    campaign block.

    Returns the replay record: the member's identity (campaign index,
    kind, mode, seed), the fresh ``replayed`` block in the exemplar
    ``expected`` format, the recorder payload (when the campaign carried
    a recorder), the exemplar verdicts (``match``, ``recorder_match``,
    ``lineage_match``: None when there is nothing to compare), the
    lineage spans when ``lineage`` is set, and the referee differential
    when ``oracle`` is set.
    """
    from rapid_tpu_torch import campaign as campaign_mod
    from rapid_tpu_torch.device import resolve_device
    from rapid_tpu_torch.engine import receiver as receiver_mod
    from rapid_tpu_torch.engine import recorder as recorder_mod
    from rapid_tpu_torch.engine.fleet import (fleet_simulate,
                                              lower_receiver_schedule,
                                              member_of,
                                              receiver_fleet_simulate,
                                              stack_members,
                                              stack_receiver_members)
    from rapid_tpu_torch.faults import ScenarioWeights
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.telemetry import lineage as lineage_lib
    from rapid_tpu_torch.telemetry import metrics as metrics_mod
    from rapid_tpu_torch.telemetry.trace import TraceWriter, trace_from_logs

    dev = resolve_device(device)
    camp = payload.get("campaign")
    if not camp:
        raise ValueError("payload has no campaign block — replay needs a "
                         "campaign artifact")
    for key in ("seed", "clusters", "n", "ticks", "headroom", "weights",
                "fleet_size"):
        if key not in camp:
            raise ValueError(
                f"campaign block lacks {key!r} — replay needs a "
                "schema >= 8 payload (re-run the campaign on this tree)")
    # The wire protocol is campaign identity; older payloads default to
    # the reference protocol.
    protocol_variant = str(camp.get("protocol_variant", "rapid"))
    cfg = campaign_mod.CampaignConfig(
        clusters=camp["clusters"], n=camp["n"], ticks=camp["ticks"],
        seed=camp["seed"], fleet_size=camp["fleet_size"],
        headroom=camp["headroom"],
        weights=ScenarioWeights(**camp["weights"]),
        per_receiver=camp["per_receiver"]["enabled"],
        flight_recorder=int(camp.get("flight_recorder") or 0),
        protocol_variant=protocol_variant)

    # The deterministic chain of run_campaign: sample, route, pool, chunk.
    # The carry layout is campaign identity too ("xla" when the payload
    # names none).
    base = Settings()
    rx_kernel = camp["per_receiver"].get("rx_kernel", "xla")
    if rx_kernel != "xla":
        base = base.with_(rx_kernel=rx_kernel)
    if protocol_variant != "rapid":
        base = base.with_(protocol_variant=protocol_variant)
    settings = base.with_(capacity=cfg.n + cfg.headroom)
    rx_settings = base.with_(capacity=cfg.n)
    if cfg.flight_recorder:
        settings = settings.with_(flight_recorder_window=cfg.flight_recorder)
        rx_settings = rx_settings.with_(
            flight_recorder_window=cfg.flight_recorder)
    f = max(1, cfg.fleet_size)
    total = -(-cfg.clusters // f) * f
    scenarios = [campaign_mod._sample_scenario(cfg, i)
                 for i in range(total)]
    _, _, plan = campaign_mod._plan(scenarios, cfg.per_receiver, f)
    if not (0 <= dispatch < len(plan)):
        raise ValueError(f"dispatch {dispatch} out of range: the plan has "
                         f"{len(plan)} dispatches")
    pool, chunk = plan[dispatch]
    if not (0 <= member_index < len(chunk)):
        raise ValueError(
            f"member_index {member_index} out of range: dispatch "
            f"{dispatch} carries {len(chunk)} real members (padded slots "
            "are cycled copies and have no campaign identity)")
    i = chunk[member_index]
    sc = scenarios[i]
    mode, shape = pool["mode"], pool["shape"]

    # A one-member fleet stacked to the pool maxima runs the member's
    # padded program, so the fold equals the dispatch's.
    writer = TraceWriter() if trace_path else None
    rec = None
    if mode == "shared":
        member = campaign_mod._lower_shared(cfg, settings, i, sc, dev)
        fleet = stack_members([member], n_windows=shape[0],
                              n_instances=shape[1], n_pids=shape[2])
        result = fleet_simulate(fleet, cfg.ticks, settings, device=dev)
        if cfg.flight_recorder:
            finals, logs, recs = result
            rec = recorder_mod.member_recorder(recs, 0)
        else:
            finals, logs = result
        summary = metrics_mod.fleet_summaries(logs)[0]
        mlog = member_of(logs, 0)
        rows = metrics_mod.engine_metrics(mlog)
        cid = int(mlog.config_hi[-1]) << 32 | int(mlog.config_lo[-1])
        meta = {"flags": 0, "config_ids": [f"{cid:016x}"]}
        lineage_spans = (lineage_lib.fold_spans(
            lineage_lib.engine_phase_columns(mlog)) if lineage else None)
        if writer is not None:
            trace_from_logs(mlog, settings, writer=writer)
    else:
        member = lower_receiver_schedule(sc.schedule, rx_settings,
                                         fleet_size=1, device=dev)
        fleet = stack_receiver_members([member], n_windows=shape[0],
                                       n_delay_rules=shape[1])
        result = receiver_fleet_simulate(fleet, cfg.ticks, rx_settings,
                                         device=dev)
        if cfg.flight_recorder:
            finals, logs, recs = result
            rec = recorder_mod.member_recorder(recs, 0)
        else:
            finals, logs = result
        # Packed fleets return packed finals; the view unpacks the fields
        # the fold reads (the dense carry passes as it is).
        mrs = receiver_mod.receiver_final_view(member_of(finals, 0))
        mlog = member_of(logs, 0)
        run = receiver_mod.receiver_run_payload(mrs, mlog, cfg.n,
                                                cfg.ticks)
        rows = run.metrics()
        summary = metrics_mod.summarize(rows)
        cids = sorted(set(receiver_mod.receiver_config_ids(mrs)[:cfg.n]))
        meta = {"flags": int(mrs.flags),
                "config_ids": [f"{x:016x}" for x in cids]}
        lineage_spans = None
        if lineage:
            # The campaign's per-receiver fold: spans from the member's
            # counters, with the critical path where the schedule delays.
            lineage_spans = lineage_lib.fold_spans(
                lineage_lib.receiver_phase_columns(mlog))
            if sc.schedule.delays:
                for sp in lineage_spans:
                    sp["critical_path"] = lineage_lib.receiver_critical_path(
                        mlog, sp, sc.schedule)

    replayed = campaign_mod._expected_block(summary, meta)
    recorder_payload = (recorder_mod.recorder_payload(rec)
                        if rec is not None else None)

    if metrics_path:
        metrics_mod.write_jsonl(rows, metrics_path)
    if writer is not None:
        writer.write(trace_path)

    cls, exemplar = _find_exemplar(payload, dispatch, member_index)
    mismatches = None
    recorder_match = None
    lineage_match = None
    if exemplar is not None:
        mismatches = _diff_blocks(exemplar["expected"], replayed)
        if exemplar.get("recorder") is not None \
                and recorder_payload is not None:
            recorder_match = exemplar["recorder"] == recorder_payload
        if lineage_spans is not None \
                and exemplar.get("lineage") is not None:
            lineage_match = exemplar["lineage"] == lineage_spans

    oracle_block = None
    if oracle:
        oracle_block = {"run": False, "passed": None, "error": None,
                        "artifact": None}
        if protocol_variant != "rapid":
            oracle_block["error"] = (
                "oracle referee replays the reference protocol only; "
                "variant exactness lives in "
                "engine.diff.run_variant_differential")
        elif sc.wants_churn:
            oracle_block["error"] = ("oracle referee replays fault "
                                     "surfaces only; churn members are "
                                     "ineligible")
        else:
            from rapid_tpu_torch.engine import diff
            from rapid_tpu_torch.telemetry.forensics import DivergenceError

            referee_settings = base.with_(capacity=0)
            oracle_block["run"] = True
            try:
                if mode == "per_receiver":
                    res = diff.run_receiver_differential(
                        sc.schedule, cfg.ticks, referee_settings,
                        device=dev)
                else:
                    res = diff.run_adversarial_differential(
                        sc.schedule, cfg.ticks, referee_settings)
                res.assert_identical(artifact=forensics_path)
                oracle_block["passed"] = True
            except (DivergenceError,
                    receiver_mod.ReceiverEnvelopeError) as err:
                oracle_block["passed"] = False
                oracle_block["error"] = str(err).splitlines()[0]
                oracle_block["artifact"] = forensics_path

    return {
        "record": "replay",
        "dispatch": dispatch,
        "member_index": member_index,
        "member": i,
        "kind": sc.kind,
        "mode": mode,
        "seed": campaign_mod._member_seed(cfg, i),
        "ticks": cfg.ticks,
        "n": cfg.n,
        "replayed": replayed,
        "recorder": recorder_payload,
        "triage_class": cls,
        "match": (not mismatches) if mismatches is not None else None,
        "mismatches": mismatches or None,
        "recorder_match": recorder_match,
        "lineage": lineage_spans,
        "lineage_match": lineage_match,
        "oracle": oracle_block,
    }


def _parse_member(text: str) -> Tuple[int, int]:
    d, _, j = text.partition(":")
    try:
        return int(d), int(j)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--member wants DISPATCH:MEMBER_INDEX (e.g. 3:17), got "
            f"{text!r}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Replay one campaign member deterministically from "
                    "its payload (see rapid_tpu_torch/replay.py docstring)")
    parser.add_argument("--payload", required=True, metavar="FILE",
                        help="campaign JSON artifact (schema >= 8, from "
                             "python -m rapid_tpu_torch.campaign --out)")
    parser.add_argument("--member", required=True, type=_parse_member,
                        metavar="D:I",
                        help="dispatch index and member index within "
                             "that dispatch, as in triage exemplar refs")
    parser.add_argument("--metrics", type=str, default=None, metavar="FILE",
                        help="write the member's per-tick TickMetrics "
                             "stream as JSONL")
    parser.add_argument("--trace", type=str, default=None, metavar="FILE",
                        help="write a Perfetto trace of the member's "
                             "virtual time (shared members only)")
    parser.add_argument("--forensics", type=str, default=None,
                        metavar="FILE",
                        help="divergence JSONL artifact path for "
                             "--oracle (written only on divergence)")
    parser.add_argument("--oracle", action="store_true",
                        help="also replay the schedule through the host "
                             "referee and report the differential")
    parser.add_argument("--lineage", action="store_true",
                        help="rebuild the member's lineage spans and "
                             "verify them against the exemplar's")
    parser.add_argument("--out", type=str, default=None, metavar="FILE",
                        help="write the replay record JSON here too")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    with open(args.payload) as fh:
        payload = json.load(fh)
    dispatch, member_index = args.member
    record = replay_member(payload, dispatch, member_index,
                           oracle=args.oracle, lineage=args.lineage,
                           metrics_path=args.metrics,
                           trace_path=args.trace,
                           forensics_path=args.forensics,
                           device=args.device)
    if args.out:
        from rapid_tpu_torch.telemetry import write_json_artifact

        write_json_artifact(args.out, record, indent=2)
    print(json.dumps(record), flush=True)
    failed = (record["match"] is False
              or record["recorder_match"] is False
              or record["lineage_match"] is False
              or (record["oracle"] or {}).get("passed") is False)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
