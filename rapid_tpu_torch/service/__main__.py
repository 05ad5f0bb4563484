"""Service entry points: ``python -m rapid_tpu_torch.service --soak`` /
``--load-sweep`` / ``--rx-soak``.

The port of the reference's CLI: the same flags, defaults, payloads and
exit codes, plus ``--device`` (default ``cuda``; without a card it
raises, it never falls back to the CPU).

``--soak`` runs the resident engine for ``--ticks`` ticks in
``Settings.stream_chunk_ticks``-sized chunks under seeded traffic,
performs one save/restore round-trip at the midpoint
(``ResidentEngine.verify_round_trip`` — restored carry proven bitwise
identical, continuation proven byte-identical), and prints the final
``stream_summary`` record as one JSON line on stdout. Exit status is
nonzero if any identity check failed or the live-buffer watermark grew.
``--target-rate`` attaches the closed-loop load servo (events/sec);
``--status`` / ``--status-socket`` attach the live status API.

``--load-sweep`` runs one fresh servo-driven resident per ``--targets``
entry, classifies each as stable/unstable by the backlog slope over the
measured chunks, locates the knee (largest stable target), and prints
one ``record: "load_sweep"`` line — the form committed as
``benchmarks/load_sweep.json``. Exit status is nonzero unless the sweep
brackets the knee (at least one stable and one unstable target).

``--rx-soak`` is the per-receiver twin of ``--soak``: a resident
receiver member (``service.rx_resident``, two-zone schedule, packed
carry by default) with the same midpoint checkpoint proof and the same
exit gates — the form committed as ``benchmarks/rx_soak.json``.

``--out`` receives the JSONL metrics stream; ``--artifact``
additionally writes a compact JSON document (summary + chunk records,
no tick rows).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile

from rapid_tpu_torch.campaign import _rate
from rapid_tpu_torch.service.resident import boot_resident
from rapid_tpu_torch.service.rx_resident import boot_resident_receiver
from rapid_tpu_torch.service.servo import LoadServo, ServoConfig
from rapid_tpu_torch.service.status import StatusPublisher
from rapid_tpu_torch.service.traffic import TrafficConfig
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry import write_json_artifact
from rapid_tpu_torch.telemetry.slo import SloWindows


def _summary_gate(summary: dict, block: dict) -> bool:
    """The soak pass/fail verdict shared by ``--soak`` and
    ``--rx-soak``: every checkpoint identity proven, and the live-buffer
    steady-state watermark within 10% of the first chunk's working set
    (double-buffering keeps two chunks of logs alive; the first drain
    already sees that — ``steady_max`` excludes the verify chunk, which
    transiently holds the live and restored branches side by side)."""
    identity_keys = ("state_identical", "logs_identical", "final_identical")
    ok = all(block[k] for k in identity_keys)
    if block["recorder_identical"] is False \
            or block["continuation_recorder_identical"] is False:
        ok = False
    marks = summary["live_buffer_bytes"]
    if marks["steady_max"] is not None and marks["first"] \
            and marks["steady_max"] > 1.10 * marks["first"]:
        print(f"live-buffer watermark grew: {marks}", file=sys.stderr)
        ok = False
    if not ok:
        print(f"soak FAILED: checkpoint block {block}", file=sys.stderr)
    return ok


def _run_soak(args) -> int:
    settings = Settings(stream_chunk_ticks=args.chunk,
                        flight_recorder_window=args.recorder)
    closed = args.closed_loop or args.target_rate is not None
    traffic = TrafficConfig(
        seed=args.seed,
        join_rate_per_ktick=args.rate,
        leave_burst_rate_per_ktick=args.leave_rate,
        leave_burst_size=args.leave_burst,
        diurnal_amplitude=args.diurnal,
        diurnal_period_ticks=args.diurnal_period,
        closed_loop=closed)
    servo = None
    if args.target_rate is not None:
        servo = LoadServo(ServoConfig(
            target_events_per_sec=args.target_rate,
            pinned_ticks_per_sec=args.pinned_tps))
    slo = (SloWindows(window_chunks=args.slo_window)
           if args.slo_window else None)
    status = None
    if args.status or args.status_socket:
        status = StatusPublisher(file_path=args.status,
                                 socket_path=args.status_socket)
    n_chunks = max(2, -(-args.ticks // args.chunk))
    ckdir = args.checkpoint_dir or tempfile.mkdtemp(prefix="rapid_soak_ck_")

    eng = boot_resident(settings, args.capacity, args.n, seed=args.seed,
                        traffic_config=traffic, servo=servo, slo=slo,
                        status=status, sink=args.out,
                        write_ticks=not args.no_tick_rows,
                        device=args.device)
    # First half, one save/restore round-trip (itself one chunk), the
    # remainder.
    first = n_chunks // 2
    eng.run(first)
    block = eng.verify_round_trip(ckdir)
    eng.run(n_chunks - first - 1)
    summary = eng.summary()
    eng.close()

    if args.artifact:
        write_json_artifact(args.artifact,
                            {"record": "soak_artifact",
                             "schema_version": summary["schema_version"],
                             "summary": summary,
                             "chunks": eng.chunk_records},
                            indent=2, sort_keys=True)

    print(json.dumps(summary, sort_keys=True))
    return 0 if _summary_gate(summary, block) else 1


def _run_load_sweep(args) -> int:
    from rapid_tpu_torch.telemetry.schema import SCHEMA_VERSION

    import time as time_mod

    settings = Settings(stream_chunk_ticks=args.chunk,
                        flight_recorder_window=0)
    targets = [float(t) for t in args.targets.split(",") if t.strip()]
    if len(targets) < 2:
        print("load-sweep needs at least two --targets", file=sys.stderr)
        return 2
    t_wall0 = time_mod.perf_counter()
    rates = []
    for target in targets:
        # Each target gets a fresh resident + servo from the same seed:
        # every executable shape repeats, so only the first target pays
        # the compile (its chunk 0 reports compile_s and excludes it
        # from the measured wall).
        traffic = TrafficConfig(
            seed=args.seed,
            join_rate_per_ktick=0.0,
            leave_burst_rate_per_ktick=args.leave_rate,
            leave_burst_size=args.leave_burst,
            closed_loop=True)
        servo = LoadServo(ServoConfig(
            target_events_per_sec=target,
            pinned_ticks_per_sec=args.pinned_tps))
        slo = SloWindows(window_chunks=args.slo_window)
        eng = boot_resident(settings, args.capacity, args.n,
                            seed=args.seed, traffic_config=traffic,
                            servo=servo, slo=slo, write_ticks=False,
                            device=args.device)
        eng.run(args.warmup + args.chunks_per_rate)
        eng.flush()
        recs = eng.chunk_records[args.warmup:]
        wall = sum(r["wall_s"] for r in recs)
        ticks = sum(r["ticks"] for r in recs)
        events = sum(r["traffic"]["events"] for r in recs)
        backlogs = [r["servo"]["backlog"] for r in recs]
        # The saturation verdict: mean per-chunk backlog growth over the
        # measured window. Below the knee the offered-minus-applied
        # backlog is bounded (slope ~0); past it the backlog grows
        # monotonically chunk over chunk.
        slope = ((backlogs[-1] - backlogs[0])
                 / max(1, len(backlogs) - 1))
        stable = slope <= args.slope_threshold
        rates.append({
            "target_events_per_sec": target,
            "achieved_events_per_sec": _rate(events, wall),
            "rate_per_ktick": eng.servo.rate_per_ktick,
            "ticks_per_sec": _rate(ticks, wall),
            "chunks": len(recs),
            "events": events,
            "backlog_final": backlogs[-1],
            "backlog_slope_per_chunk": slope,
            "stable": bool(stable),
            "servo_config": servo.config.as_dict(),
            "slo": recs[-1]["slo"],
        })
        eng.close()

    knee = None
    stable_rates = [r for r in rates if r["stable"]]
    if stable_rates:
        best = max(stable_rates, key=lambda r: r["target_events_per_sec"])
        knee = {
            "target_events_per_sec": best["target_events_per_sec"],
            "achieved_events_per_sec": best["achieved_events_per_sec"],
            "ticks_to_view_change_p99":
                best["slo"]["metrics"]["ticks_to_view_change"]["p99"],
        }
    payload = {
        "record": "load_sweep",
        "schema_version": SCHEMA_VERSION,
        "n": args.n,
        "capacity": args.capacity,
        "chunk_ticks": args.chunk,
        "chunks_per_rate": args.chunks_per_rate,
        "warmup_chunks": args.warmup,
        "seed": args.seed,
        "backlog_slope_threshold": args.slope_threshold,
        "targets": targets,
        "rates": rates,
        "knee": knee,
        "wall_s": time_mod.perf_counter() - t_wall0,
    }
    if args.artifact:
        write_json_artifact(args.artifact, payload, indent=2,
                            sort_keys=True)
    print(json.dumps(payload, sort_keys=True))
    n_stable = len(stable_rates)
    n_unstable = len(rates) - n_stable
    if n_stable == 0 or n_unstable == 0:
        print(f"load sweep did not bracket the knee: {n_stable} stable, "
              f"{n_unstable} unstable target(s) — widen --targets",
              file=sys.stderr)
        return 1
    return 0


def _run_rx_soak(args) -> int:
    settings = Settings(rx_kernel=args.kernel,
                        flight_recorder_window=args.recorder)
    n_chunks = max(2, -(-args.ticks // args.chunk))
    ckdir = args.checkpoint_dir or tempfile.mkdtemp(prefix="rapid_rx_ck_")
    slo = (SloWindows(window_chunks=args.slo_window)
           if args.slo_window else None)
    rx = boot_resident_receiver(
        settings, args.n, seed=args.seed,
        horizon_ticks=args.horizon or n_chunks * args.chunk,
        chunk_ticks=args.chunk, slo=slo, sink=args.out,
        device=args.device)
    first = n_chunks // 2
    rx.run(first)
    block = rx.verify_round_trip(ckdir)
    rx.run(n_chunks - first - 1)
    summary = rx.summary()
    rx.close()

    if args.artifact:
        write_json_artifact(args.artifact,
                            {"record": "rx_soak_artifact",
                             "schema_version": summary["schema_version"],
                             "summary": summary,
                             "chunks": rx.chunk_records},
                            indent=2, sort_keys=True)

    print(json.dumps(summary, sort_keys=True))
    return 0 if _summary_gate(summary, block) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rapid_tpu_torch.service")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--soak", action="store_true",
                      help="run the chunked resident-engine soak")
    mode.add_argument("--load-sweep", action="store_true",
                      help="servo-driven saturation sweep over --targets")
    mode.add_argument("--rx-soak", action="store_true",
                      help="run the receiver-resident soak")
    ap.add_argument("--n", type=int, default=24,
                    help="initial converged members (--rx-soak: the "
                         "receiver capacity C)")
    ap.add_argument("--capacity", type=int, default=96,
                    help="slot universe (members + joiner pool)")
    ap.add_argument("--ticks", type=int, default=102400,
                    help="total ticks (rounded up to whole chunks)")
    ap.add_argument("--chunk", type=int, default=512,
                    help="chunk size in ticks (Settings."
                         "stream_chunk_ticks for the engine modes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="Poisson join arrivals per 1000 ticks")
    ap.add_argument("--leave-rate", type=float, default=2.0,
                    help="correlated leave bursts per 1000 ticks")
    ap.add_argument("--leave-burst", type=int, default=4)
    ap.add_argument("--diurnal", type=float, default=0.3,
                    help="diurnal join-rate amplitude in [0, 1]")
    ap.add_argument("--diurnal-period", type=int, default=4096)
    ap.add_argument("--recorder", type=int, default=8,
                    help="flight_recorder_window (0 disables)")
    ap.add_argument("--closed-loop", action="store_true",
                    help="closed-loop traffic sampling (implied by "
                         "--target-rate)")
    ap.add_argument("--target-rate", type=float, default=None,
                    help="attach the load servo steering toward this "
                         "many events/sec")
    ap.add_argument("--pinned-tps", type=float, default=None,
                    help="pin the servo throughput model (deterministic "
                         "replays)")
    ap.add_argument("--slo-window", type=int, default=8,
                    help="rolling SLO window in chunks (0 disables)")
    ap.add_argument("--status", default=None,
                    help="atomically-replaced live status JSON file")
    ap.add_argument("--status-socket", default=None,
                    help="unix-domain status/watch line-protocol socket")
    ap.add_argument("--targets", default="50,200,800,1600,3200",
                    help="comma list of events/sec targets (--load-sweep)")
    ap.add_argument("--chunks-per-rate", type=int, default=12,
                    help="measured chunks per target (--load-sweep)")
    ap.add_argument("--warmup", type=int, default=3,
                    help="unmeasured warmup chunks per target "
                         "(--load-sweep)")
    ap.add_argument("--slope-threshold", type=float, default=5.0,
                    help="max stable backlog growth per chunk "
                         "(--load-sweep)")
    ap.add_argument("--kernel", default="packed",
                    choices=("xla", "packed", "pallas"),
                    help="receiver kernel (--rx-soak)")
    ap.add_argument("--horizon", type=int, default=None,
                    help="fault-schedule horizon in ticks (--rx-soak; "
                         "default: the whole run)")
    ap.add_argument("--out", default=None,
                    help="JSONL metrics sink (default: no stream file)")
    ap.add_argument("--no-tick-rows", action="store_true",
                    help="sink gets heartbeats + summary only")
    ap.add_argument("--artifact", default=None,
                    help="compact JSON artifact (summary + chunk "
                         "records, or the load_sweep payload)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="where the mid-soak checkpoint lands "
                         "(default: a temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu runs "
                         "the plain-PyTorch path)")
    args = ap.parse_args(argv)
    if args.load_sweep:
        return _run_load_sweep(args)
    if args.rx_soak:
        return _run_rx_soak(args)
    if not args.soak:
        ap.error("nothing to do: pass --soak, --load-sweep, or --rx-soak")
    return _run_soak(args)


if __name__ == "__main__":
    sys.exit(main())
