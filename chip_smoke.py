#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``rapid_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. the card's name and power limit; build both delivery kernels
   (``rapid_tpu_torch/engine/csrc/rx_deliver.cu``, the main path's, and
   ``rx_account.cu``, the packed kernel kept as the yardstick) into one
   library and print the build time;
2. each kernel against its plain PyTorch version on random planes, bit
   for bit (tolerance: exact): ``rx_deliver`` at C in {13, 64, 200, 1000,
   1024, 4096} with one and two planes, adding onto nonzero counters
   with and without a phase slot; ``rx_account`` at C in {64, 200, 1000,
   1024, 4096};
3. the golden run: N=64, 160 ticks of the crash + partition + delay
   scenario against ``rapid_tpu_torch/testdata/rx_n64_golden.json``
   (the reference's counters, phase counters, events and config ids);
4. the main path at full width: N=1024, 160 ticks of the same scenario
   through ``lower_receiver_schedule`` and ``receiver_simulate``; flags
   clear, a view change decided, survivors on one config id,
   ``rx_deliver`` launched 6 times per tick and ``rx_account`` never, and
   the whole run equal to the same run with the plain version swapped
   in and to the run with the packed composition (``account`` around
   ``rx_account``) swapped in. Then, through ``rapid_tpu_torch.tick_time``,
   the default (``rx_deliver``) and the composed path in turns on this
   card (default, composed, composed, default, the runs above their
   warm-up; every run equal to the first and launching only its own
   kernel), ms per tick each; the host's µs per delivery call inside a
   tick for each path; and kernels per tick of each path over ticks
   106-113 (``PROFILE_TICKS``) under ``torch.profiler``;
5. N=4096, 8 ticks with one partition window: peak memory and time per
   tick;
6. the shared-state engine (``init_state`` then ``simulate``) at N=1,000,
   160 ticks of a 1 % crash burst, equal to its golden file
   (``rapid_tpu_torch/testdata/shared_n1000_crash.json``);
7. the shared engine's main path at N=100,000: 160 ticks of a 1 % crash
   burst at tick 5, equal to its golden file (events, every per-tick
   ``StepLog`` scalar, the expanded counters, the final config id and a
   SHA-256 of every final-state field), deciding at tick 113 with 99,000
   members; prints ms per tick (CUDA events), host reads per tick and
   peak allocated memory;
8. the same at N=100,000 with probe drop p = 0.3 and a one-way flip-flop
   window, equal to its golden file;
9. churn at N=100,000: 100,096 slots, 24 alternating join and leave
   bursts of 8 slots (``churn.synthetic_churn_schedule``) through
   ``init_state(member=, id_fps=)`` and ``simulate(churn=)``, 160 ticks,
   equal to ``shared_n100k_churn.json``, 24 decides and 100,000 members
   at the end;
10. contested consensus at N=100,000: 8 scripted split votes
    (``paxos.synthetic_contested_schedule``) through
    ``simulate(fallback=)``, 160 ticks, equal to
    ``shared_n100k_contested.json``, 8 decides by the classic round (the
    first at tick 19) and 99,992 members; prints the per-phase message
    totals;
11. phase 7's burst with ``protocol_variant="ring"``, equal to
    ``shared_n100k_crash_ring.json`` (the same events and config ids as
    phase 7), printing its message factors beside phase 7's;
12. the same with ``"hier"``, equal to ``shared_n100k_crash_hier.json``;
13. the invariant monitor: phases 7 and 10 with ``invariant_checks=True``,
    every ``inv_bits`` 0 and every field equal to their golden files, each
    also in turns with the monitor off (off, on, on, off); then a memsum
    limb corrupted at boot flags bit 5 from tick 1 at N=100,000 and
    ``check_run`` raises naming tick 1;
14. the flight recorder, 64 rows: on phase 7's run, equal to
    ``shared_n100k_crash_rec64.json`` (ring rows and stamps too), and on
    phase 4's N=1024 receiver run, equal to ``rx_n1024_recorder.json``,
    with ``rx_deliver`` launched 6 times a tick and ``rx_account`` never;
    the shared run in turns with the recorder off, the receiver run then
    once without it and once more with it, every run equal to the first;
15. churn planned by the port's ``plan_churn`` (in a child process run
    as ``chip_smoke.py --planned`` under the ``PYTHONHASHSEED`` the golden
    files were made with): N=100,000 with two 16-slot join and two leave
    bursts, equal to ``shared_n100k_planned_churn.json``, and N=10,000
    with a 5 % contiguous crash block and the same bursts, 200 ticks,
    equal to ``shared_n10k_planned_mixed.json``; each runs twice, from
    two boots (the child's first run also loads the card's kernels, so
    the second is the warm one); prints the planner's seconds;
16. ``rx_deliver`` over a member axis (``[F, B, C, C]`` planes, ``[F, C]``
    crash masks, ``[F, 14]`` counters starting nonzero) equal to its plain
    version at C in {13, 32, 48, 1024}, F in {1, 4, 256} (256 at C <= 48)
    and B in {1, 2}, with and without a phase slot; then at F=256 and
    C in {32, 48}: device time L2-warm and L2-cold (graph replay), the
    byte bound, 256 launches of one member each, and the plain version;
17. the main path of fleets: the four pools of
    ``rapid_tpu_torch/testdata/fleet_pool{0,1,2,3}.json`` (a campaign's
    first 256 members of each: shared crash and churn, shared contested,
    per-receiver latency, per-receiver partition and flip-flop), each
    lowered by the port from the file's schedules, stacked to the file's
    shape and run 120 ticks, equal to the file for every member; prints
    ms per tick and per member-tick, host reads per tick, kernels per
    tick over ticks 1-5 under ``torch.profiler``, peak memory and
    ``rx_deliver``'s launches (720 for a per-receiver pool, none for a
    shared one), counted from 0 around each pool's run;
18. scaling: pools 0 and 3 at F in {1, 16, 64, 256} (prefixes of the same
    members), 40 ticks, each F once from small to large, each run's
    logs equal to phase 17's for those members and ticks, printing ms
    per member-tick;
    and member 0 through the one-cluster entry points (``simulate``,
    ``receiver_simulate``), 120 ticks, equal to its entry;
19. the per-receiver carry layouts at the main path's width: phase 4's
    run under ``Settings()`` (``rx_kernel="xla"``, the dense carry) and
    under ``"packed"``, one run each, every run equal to phase 4's (logs
    and final state), ``rx_deliver`` 960 launches and ``rx_account``
    none each (phase 4 itself runs ``"pallas"``, the packed code);
    prints ms/tick, host reads/tick and peak memory per layout, and
    kernels per tick over ticks 106-113 under ``torch.profiler``;
20. phase 5's N=4096 partition under ``"xla"``, in turns with
    ``"pallas"`` (xla, pallas, pallas, xla), phase 5's checks on each
    run and the two layouts' runs equal; ms/tick and peak memory each;
21. dense fleets: pools 2 and 3 of phase 17 lowered under ``"xla"``,
    F=256, 120 ticks, equal to their golden files for every member,
    ``rx_deliver`` 720 launches a pool; ms/tick, µs per member-tick,
    kernels per tick over ticks 1-5 and peak memory beside phase 17's
    packed runs;
22. telemetry of the card's logs: the port's folds
    (``rapid_tpu_torch.telemetry``) of phases 7, 9 and 10, of phase 14's
    N=1024 recorder run and of phase 17's pools 0 and 2, each equal to
    ``rapid_tpu_torch/testdata/telemetry_golden.json`` (the reference's
    folds) and clean under the port's validators, with the host seconds
    of each fold; and one Perfetto trace of phase 7's logs written into
    a temporary directory and loaded back (phase slices, the proposal at
    112 and the view change at 113);
23. the host referee holds the per-receiver engine at the main path's
    width (``engine.diff.run_receiver_differential``, N=1024), under
    ``Settings()`` (the dense carry) and ``rx_kernel="packed"``,
    ``rx_deliver`` 6 launches a tick and ``rx_account`` none each, the two
    device runs equal each other: phase 4's scenario (160 ticks), equal
    to phase 4's run, whose first divergence from the referee is the one
    the reference's own engine has there (``MAIN_REFEREE_DIVERGENCE``, a
    delayed alert batch landing in the decide tick; ROADMAP.md Queue 3);
    the same scenario with its delay rule ended at tick 100 (160 ticks),
    exact (``assert_identical``: every slot's events, per-tick counters,
    per-phase counters and config id), whose rule then delays nothing;
    ``half_delay_schedule`` (200 ticks), exact, with half the senders'
    alert batches and votes delayed 2-3 ticks; and the slow-voter
    scenario of ``tests/test_delay.py`` at N=64 (delay 40, ring 48, 400
    ticks), exact and decided by the classic round with no drop. Counts
    the sends each scenario's delay rule held back (a second referee
    run), and prints the referee's host seconds and the device run's
    ms/tick apart;
24. the full oracle cluster holds the shared engine at N=256, each
    ``assert_identical``: a crash burst, joins and leaves, a joiner whose
    first node-id draw collides (the identifier redraw), a contested
    instance decided by the classic round, and the burst under "ring" and
    "hier"; prints the oracle's host seconds and the engine's ms/tick;
25. the slice's main path, a campaign at full width:
    ``campaign.run_campaign`` at ``benchmarks/campaign_4096.json``'s
    configuration (4,096 clusters of N=32, 120 ticks, seed 0, dispatches
    of 256, 16 churn slots, every kind at weight 1, a 16-row recorder,
    the dense carry): 18 dispatches in 4 pools, ``rx_deliver`` launched
    7,920 times (6 a tick of 11 per-receiver dispatches); the payload
    equal to ``rapid_tpu_torch/testdata/campaign_4096_reference.json``
    (the reference's payload without its wall keys) in every field, its
    ``campaign`` block equal to the committed file's on every key the
    file has but ``per_receiver.capacity_cap`` (4,096 since the file was
    written), ``bench_compare``'s exact fields (``exact_errors``, a copy
    of them) clean against the golden file, and the port's schema
    validators clean; prints the wall, the six stage sums, device-busy
    and host-blocked seconds, clusters/s, µs per member-tick per pool and
    the peak memory;
26. replay: every triage exemplar of ``benchmarks/campaign_4096.json``
    (12) through ``replay.replay_member``, each verified (``match`` and
    ``recorder_match``) with its lineage spans equal to phase 25's
    exemplar's; the one of ``campaign_rx4096.json`` (N=4096, 8 ticks, the
    packed carry); and ``oracle=True`` on 5:0 and 7:58, each verdict the
    reference's (``REPLAY_ORACLE_VERDICTS``);
27. the other committed payloads: a campaign at ``baseline.json``'s
    ``fleet`` configuration, clean on the exact fields against that
    entry, and ``run_tournament(["rapid", "ring"])`` at
    ``campaign_tournament.json``'s configuration, its whole ``campaign``
    block equal to the file's;
28. checkpoints from the reference: each of
    ``rapid_tpu_torch/testdata/checkpoints/{engine,receiver_dense,
    receiver_packed}`` (written by the reference's ``save_checkpoint``:
    the soak after 2 chunks, the two-zone N=64 member after 6 chunks of
    16, each with an 8-row recorder) restored on the card, continued one
    chunk, saved, loaded and continued again, equal to
    ``continuations.json`` (the reference's uninterrupted run: a SHA-256
    of every log and final-state field, the recorder's rows and stamps,
    the traffic state); every manifest valid; a version, statics and
    leaf-table mismatch raise the reference's errors and messages;
29. the soak at ``benchmarks/soak.json``'s configuration (N=24 in 96
    slots, chunks of 512, the reference CLI's traffic, recorder 8, SLO
    window 8), ``SOAK_CHUNKS`` chunks with the round trip at
    ``SOAK_VERIFY_AT``: every chunk record equal to the file's on its
    keys but the walls, the round trip's block all true, the stream
    valid, the watermark gate (``steady_max <= 1.10 * first``) held;
    prints ms per tick, ticks/s, and the host's dispatch and fence
    seconds against the card's busy share under ``torch.profiler``;
30. the per-receiver soak at ``benchmarks/rx_soak.json``'s
    configuration (N=1024, "packed", 12 chunks of 16, the round trip at
    tick 96): every record and the summary equal to the file's (896
    decisions), ``rx_deliver`` launched 1,248 times (6 a tick over the
    208 ticks run) and ``rx_account`` never; then the same under
    ``Settings()`` (the dense carry), every record equal to the packed
    run's, the same launches; ms per tick and peak memory per layout;
31. a resident shared engine at N=100,000 in 100,096 slots, the soak's
    traffic, 6 chunks of 256 with the round trip at chunk 3, equal to
    ``rapid_tpu_torch/testdata/stream_n100k.json`` (every record, the
    summary, a SHA-256 of every final-state field); ms per tick and peak
    memory beside phase 7's;
32. the pinned servo (``--target-rate 40 --pinned-tps 1000`` at the
    soak's configuration, 8 chunks) with a status file and socket
    attached: every record, servo blocks included, equal to
    ``rapid_tpu_torch/testdata/stream_servo.json``; one snapshot a chunk,
    each valid; ``read_status`` answers and ``watch`` streams every
    frame.

Between phases 5 and 6 the kernels are timed at C=1024 and 4096: device
time per launch (CUDA graph replay), time per eager wrapper call, the
plain version's time and the byte bound, for ``rx_deliver``, for the
whole ``account`` on the same inputs and for ``rx_account`` alone.
Phases 6-15 print ms per tick (CUDA events around ``simulate``), host
reads per tick, peak allocated memory, the decides and the setup seconds
(the schedule and ``init_state``), and count both kernels' launches in
each (none on the shared engine, which has no kernel); phases 17 and 18
the same for fleets.

``rx_deliver``'s entry of the ``kernels`` line carries its launches on
phase 4's run under each layout (``launches_by_layout``) and on each of
phase 23's runs (``referee_launches``), phase 25's campaign
(``campaign_launches``), phase 26's replays (``replay_launches``),
phase 27's runs (``committed_launches``), phase 28's receiver
continuations (``checkpoint_launches``) and phase 30's soaks per layout
(``stream_launches``). The line
before the last is the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``. The script needs a CUDA device and the
repository beside it; it imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

MAIN_N = 1024                   # kernel times: the main path's width
WIDE_N = 4096
WIDE_TICKS = 8
PARITY_WIDTHS = (64, 200, 1000, 1024, 4096)
DELIVER_WIDTHS = (13, 64, 200, 1000, 1024, 4096)
COUNTERS_START = (5, -2, 9, 4, 1)   # nonzero counters the kernels add onto
PHASE_SLOT = 3
FLEET_WIDTHS = (13, 32, 48, 1024)   # phase 16: rx_deliver over a member axis
FLEET_F = (1, 4, 256)              # members (256 only at C <= 48)
FLEET_MEMBERS = 256                # the campaign's dispatch size
FLEET_PROFILE_TICKS = 5            # phases 17 and 21: the profiled window
SCALE_F = (1, 16, 64, 256)         # phase 18's fleet sizes ...
SCALE_TICKS = 40                   # ... and ticks
TURN_ROUNDS = 1                # rounds of default, composed, composed, default
PROFILE_TICKS = 8               # phases 4 and 19: ticks 106-113 profiled
SLOW_N, SLOW_TICKS = 64, 400   # phase 23's slow-voter scenario
HALF_DELAY_TICKS = 200         # phase 23's half_delay scenario
SHARED_REFEREE_N = 256         # phase 24: the widest oracle-cluster runs
#: The first divergence of phase 23's main scenario from the host referee
#: (tick, field, card, referee): the reference's own per-receiver engine
#: gives it (testdata/rx_n1024_recorder.json against the referee).
MAIN_REFEREE_DIVERGENCE = [112, "counters.sent", 653312, 1046528]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
L2_BYTES = 50 * 2**20          # H100 L2 cache


_START = time.perf_counter()


def log(msg: str) -> None:
    """One progress line, stamped with the seconds since the start."""
    print(f"[{time.perf_counter() - _START:7.1f} s] {msg}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of ``fn()`` in ms over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 100, reps: int = 5) -> float:
    """Device time of one ``fn()`` in ms: ``iters`` calls captured in a
    CUDA graph and replayed ``reps`` times, timed by CUDA events, so the
    host's per-call overhead is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def random_planes(c: int, seed: int, device):
    """Packed message/blocked planes and crash masks with zero pad bits."""
    import torch
    from rapid_tpu_torch.engine.rx_packed import pack_bits

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)
    msgs = t(rng.random((c, c)) < 0.5)
    blocked = t(rng.random((c, c)) < 0.2)
    crashed = t(rng.random(c) < 0.1)
    pm = pack_bits(msgs)
    pe = pack_bits(blocked)
    src = torch.where(crashed, 0, 0xFF).to(torch.uint8)[:, None].contiguous()
    pd = pack_bits(~crashed)[None, :].contiguous()
    return pm, pe, src, pd


def random_dense(c: int, planes: int, seed: int, device):
    """Dense message planes, a packed blocked plane and a crash mask."""
    import torch
    from rapid_tpu_torch.engine.rx_packed import pack_bits

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)
    msgs = t(rng.random((planes, c, c)) < 0.5)
    pe = pack_bits(t(rng.random((c, c)) < 0.2))
    crashed = t(rng.random(c) < 0.1)
    return msgs, crashed, pe


def deliver_bytes(c: int, planes: int) -> int:
    """Bytes one ``rx_deliver`` launch must move: msgs read and deliv
    written (planes * C * C bytes each), pe (C * ceil(C/8)) and crashed
    (C) read, the counters (16 bytes) written."""
    return 2 * planes * c * c + c * -(-c // 8) + c + 16


def deliver_bound_ms(c: int, planes: int) -> float:
    """Least time of one ``rx_deliver`` launch at the memory rate."""
    return deliver_bytes(c, planes) / HBM_BYTES_PER_S * 1e3


def bound_ms(c: int) -> float:
    """Least time of one launch: pm and pe read, dv written (C * ceil(C/8)
    bytes each), src (C) and pd (ceil(C/8)) read, cnt (16 C) written."""
    cb = -(-c // 8)
    return (3 * c * cb + c + cb + 16 * c) / HBM_BYTES_PER_S * 1e3


def phase_build(rx_account) -> float:
    start = time.perf_counter()
    path = rx_account.build()
    rx_account._load()
    seconds = time.perf_counter() - start
    log(f"phase 1: built rx_deliver and rx_account into {path.name} and "
        f"loaded it in {seconds:.2f} s")
    return seconds


def phase_parity_deliver(rx_account, device) -> int:
    import torch

    worst = 0
    for c in DELIVER_WIDTHS:
        for planes in (1, 2):
            msgs, crashed, pe = random_dense(c, planes, seed=c + planes,
                                             device=device)
            for phase in (None, PHASE_SLOT):
                start = torch.tensor(COUNTERS_START, dtype=torch.int32,
                                     device=device)
                acc_k, acc_p = start.clone(), start.clone()
                got = rx_account.account_into_kernel(msgs, crashed, pe,
                                                     acc_k, phase)
                want = rx_account.account_into_plain(msgs, crashed, pe,
                                                     acc_p, phase)
                torch.cuda.synchronize()
                err = max(int((got.int() - want.int()).abs().max()),
                          int((acc_k - acc_p).abs().max()))
                worst = max(worst, err)
                if err:
                    raise AssertionError(
                        f"rx_deliver != plain at C={c}, B={planes}, "
                        f"phase={phase}: max |diff| {err}")
            log(f"phase 2: rx_deliver C={c} B={planes} == plain (deliv and "
                f"counters, with and without a phase slot), counters "
                f"{acc_k.tolist()}")
    return worst


def phase_parity(rx_account, device) -> int:
    import torch

    worst = 0
    for c in PARITY_WIDTHS:
        pm, pe, src, pd = random_planes(c, seed=c, device=device)
        dv_k, cnt_k = rx_account.account_kernel(pm, pe, src, pd)
        dv_p, cnt_p = rx_account.account_plain(pm, pe, src, pd)
        torch.cuda.synchronize()
        err = max(int((dv_k.int() - dv_p.int()).abs().max()),
                  int((cnt_k - cnt_p).abs().max()))
        worst = max(worst, err)
        if err:
            raise AssertionError(f"kernel != plain at C={c}: max |diff| "
                                 f"{err}")
        log(f"phase 2: rx_account C={c} == plain (dv and 3 counts), "
            f"delivered={int(cnt_k[:, 1].sum())}")
    return worst


def simulate_ms(member, settings, ticks: int):
    """``receiver_simulate`` from ``member``'s boot: final state, logs and
    ms per tick by CUDA events."""
    import torch
    from rapid_tpu_torch.engine import receiver

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    final, logs = receiver.receiver_simulate(member.state, member.faults,
                                             ticks, settings)
    end.record()
    end.synchronize()
    return final, logs, start.elapsed_time(end) / ticks


def run(schedule, settings, ticks: int, device):
    from rapid_tpu_torch.engine import receiver

    member = receiver.lower_receiver_schedule(schedule, settings,
                                              device=device)
    return (member, *simulate_ms(member, settings, ticks))


def zero_counts(rx_account) -> None:
    rx_account.launches = 0
    rx_account.deliver_launches = 0


def phase_golden(settings, device) -> None:
    from rapid_tpu_torch import golden
    from rapid_tpu_torch.engine import receiver
    from rapid_tpu_torch.faults import crash_window_delay_schedule

    want = golden.load()
    _, final, logs, ms = run(crash_window_delay_schedule(golden.GOLDEN_N),
                             settings, golden.GOLDEN_TICKS, device)
    receiver.check_flags(final.flags)
    diff = golden.differences(golden.run_record(final, logs,
                                                golden.GOLDEN_N), want)
    if diff:
        raise AssertionError(f"golden N=64 run differs in {diff}")
    log(f"phase 3: N=64 x {golden.GOLDEN_TICKS} ticks equals the golden "
        f"file ({ms:.2f} ms/tick)")


def same_run(a, b) -> bool:
    from rapid_tpu_torch.convert import to_numpy

    a, b = to_numpy(a), to_numpy(b)
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in a._fields)


def phase_main(rx_account, settings, device, keep: dict) -> dict:
    from rapid_tpu_torch import tick_time
    from rapid_tpu_torch.engine import receiver
    from rapid_tpu_torch.faults import crash_window_delay_schedule

    n, ticks = tick_time.N, tick_time.TICKS
    schedule = crash_window_delay_schedule(n)
    zero_counts(rx_account)
    member, final, logs, ms_tick = run(schedule, settings, ticks, device)
    fused, packed = rx_account.deliver_launches, rx_account.launches
    receiver.check_flags(final.flags)
    if fused != 6 * ticks or packed != 0:
        raise AssertionError(f"rx_deliver launched {fused} times (want "
                             f"{6 * ticks}), rx_account {packed} (want 0)")
    decided = int(logs.decide.sum())
    if decided < 1:
        raise AssertionError("no view change decided")
    stopped = final.stopped.cpu().numpy()[:n]
    crashed = schedule.crash_tick_array() <= ticks
    ids = np.array(receiver.receiver_config_ids(final)[:n], np.uint64)
    survivors = ~stopped & ~crashed
    if len(set(ids[survivors].tolist())) != 1:
        raise AssertionError("survivors disagree on the config id")
    log(f"phase 4: N={n} x {ticks} ticks: {ms_tick:.2f} ms/tick, "
        f"{fused} rx_deliver launches, {packed} rx_account launches, "
        f"{decided} slot decides, {int(survivors.sum())} survivors on one "
        f"config id")

    final_p, logs_p, _ = tick_time.timed(member, settings,
                                         rx_account.account_into_plain)
    if not (same_run(final, final_p) and same_run(logs, logs_p)):
        raise AssertionError("rx_deliver run != plain-version run")
    log("phase 4: whole run equals the run with account_into_plain "
        "swapped in")

    def check(name, final_t, logs_t):
        counts = (rx_account.deliver_launches, rx_account.launches)
        want = ((6 * ticks, 0) if name == "default"
                else (0, 7 * ticks))
        if counts != want:
            raise AssertionError(f"{name} run launched (rx_deliver, "
                                 f"rx_account) {counts}, want {want}")
        if not (same_run(final, final_t) and same_run(logs, logs_t)):
            raise AssertionError(f"{name} run != the first rx_deliver run")
        zero_counts(rx_account)

    zero_counts(rx_account)
    turns = tick_time.in_turns(member, settings, tick_time.PATHS,
                               TURN_ROUNDS, check, warm=False)
    log("phase 4: in turns (default is rx_deliver, composed the packed "
        "composition around rx_account), every run equal to the first")
    for name, runs in turns.items():
        log(f"phase 4: {name} path, ms/tick in run order "
            f"{[round(t, 2) for t in runs]}: mean "
            f"{sum(runs) / len(runs):.2f}, range {min(runs):.2f}-"
            f"{max(runs):.2f}")
    calls = {name: tick_time.call_us(member, settings, name)
             for name in tick_time.PATHS}
    for name, c in calls.items():
        log(f"phase 4: {name} path, {c['calls']} delivery calls in "
            f"{ticks} ticks, {c['host_us_per_call']:.1f} us of host time "
            f"per call inside the tick")
    windows = tick_time.windows(member, settings, tick_time.PATHS,
                                PROFILE_TICKS)
    for name, w in windows.items():
        log(f"phase 4: {name} path, ticks {w['from_tick'] + 1}-"
            f"{w['from_tick'] + w['ticks']} under torch.profiler: "
            f"{w['device_kernels_per_tick']:.1f} kernels/tick, "
            f"{w['aten_ops_per_tick']:.1f} aten ops/tick, "
            f"{w['wall_ms_per_tick']:.2f} ms/tick wall, "
            f"{w['device_busy_ms_per_tick']:.3f} ms/tick device-busy")
    zero_counts(rx_account)
    keep["main"] = (final, logs)
    return {"n": n, "ticks": ticks, "deliver_launches": fused,
            "account_launches": packed,
            "ms_per_tick": ms_tick, "decided": decided, "in_turns": turns,
            "delivery_calls": calls, "profile": windows}


def wide_schedule():
    """Phase 5's schedule: a one-way partition of the first eighth of
    N=4096 from tick 3."""
    from rapid_tpu_torch.faults import AdversarySchedule, LinkWindow

    n = WIDE_N
    cut = n // 8
    return AdversarySchedule(
        n=n, windows=(LinkWindow(src_slots=frozenset(range(cut)),
                                 dst_slots=frozenset(range(cut, n)),
                                 start_tick=3),), seed=1)


def check_wide(rx_account, final, logs) -> None:
    """Phase 5's checks of one N=4096 run."""
    from rapid_tpu_torch.engine import receiver

    counts = (rx_account.deliver_launches, rx_account.launches)
    if counts != (6 * WIDE_TICKS, 0):
        raise AssertionError(f"N={WIDE_N} launched (rx_deliver, rx_account)"
                             f" {counts}, want {(6 * WIDE_TICKS, 0)}")
    receiver.check_flags(final.flags)
    cut = WIDE_N // 8
    edges = logs.partitioned_edges.cpu().numpy()
    want = np.array([cut * (WIDE_N - cut) if t >= 3 else 0
                     for t in range(1, WIDE_TICKS + 1)])
    if not np.array_equal(edges, want):
        raise AssertionError(f"partitioned edges {edges} != {want}")
    if len(set(receiver.receiver_config_ids(final))) != 1:
        raise AssertionError("config ids diverged without a decide")


def phase_wide(rx_account, settings, device) -> dict:
    import torch

    torch.cuda.reset_peak_memory_stats()
    zero_counts(rx_account)
    _, final, logs, ms_tick = run(wide_schedule(), settings, WIDE_TICKS,
                                  device)
    peak = torch.cuda.max_memory_allocated()
    launches = rx_account.deliver_launches
    check_wide(rx_account, final, logs)
    log(f"phase 5: N={WIDE_N} x {WIDE_TICKS} ticks: {ms_tick:.1f} ms/tick, "
        f"peak {peak / 2**30:.2f} GiB, {launches} rx_deliver launches")
    return {"ms_per_tick": ms_tick, "peak_bytes": peak,
            "deliver_launches": launches}


def kernel_times(rx_account, device) -> dict:
    """Per launch at the main path's width and at C=4096, one plane:
    device time (CUDA graph replay), time per eager wrapper call with its
    host overhead (CUDA events around eager calls), the plain version's
    device time and the byte bound, for ``rx_deliver``, for the whole
    ``account`` on the same inputs (same function, same bound) and for
    the ``rx_account`` kernel alone on packed planes. Replays of one set
    of inputs find them in L2. ``rx_deliver``'s ``cold_ms`` cycles
    through input sets whose bytes read come to at least twice the L2,
    and keeps every captured launch's output alive, so each launch
    writes memory of its own. Launches made here are not counted."""
    import itertools

    import torch

    out = {}
    saved = (rx_account.launches, rx_account.deliver_launches)
    for c in (MAIN_N, WIDE_N):
        msgs, crashed, pe = random_dense(c, 1, seed=7, device=device)
        acc = torch.zeros(5, dtype=torch.int32, device=device)
        args = (msgs, crashed, pe, acc, PHASE_SLOT)
        fused = lambda: rx_account.account_into_kernel(*args)
        whole = lambda: rx_account.account_into_composed(*args)
        plain = graph_ms(lambda: rx_account.account_into_plain(*args))
        bound = deliver_bound_ms(c, 1)
        out[c] = {
            "rx_deliver": {"ms": graph_ms(fused), "call_ms": cuda_ms(fused,
                                                                     200),
                           "plain_ms": plain, "bound_ms": bound},
            "composed": {"ms": graph_ms(whole),
                            "call_ms": cuda_ms(whole, 200),
                            "plain_ms": plain, "bound_ms": bound}}
        read = c * c + c * -(-c // 8) + c      # msgs, pe and crashed
        count = -(-2 * L2_BYTES // read)
        sets = itertools.cycle([random_dense(c, 1, seed=8 + k, device=device)
                                for k in range(count)])
        kept = []
        out[c]["rx_deliver"]["cold_ms"] = graph_ms(
            lambda: kept.append(rx_account.account_into_kernel(
                *next(sets), acc, PHASE_SLOT)))
        log(f"kernel times C={c} rx_deliver cold: {count} input sets "
            f"({count * read / L2_BYTES:.2f} x L2 read), every output "
            f"kept: {out[c]['rx_deliver']['cold_ms'] * 1e3:.3f} us/launch")
        kept.clear()
        planes = random_planes(c, seed=7, device=device)
        alone = lambda: rx_account.account_kernel(*planes)
        out[c]["rx_account"] = {
            "ms": graph_ms(alone), "call_ms": cuda_ms(alone, 200),
            "plain_ms": graph_ms(lambda: rx_account.account_plain(*planes)),
            "bound_ms": bound_ms(c)}
        for name, t in out[c].items():
            log(f"kernel times C={c} {name}: {t['ms'] * 1e3:.3f} us/launch "
                f"on the device, {t['call_ms'] * 1e3:.2f} us per eager "
                f"call, plain {t['plain_ms'] * 1e3:.2f} us, bound "
                f"{t['bound_ms'] * 1e3:.3f} us")
    rx_account.launches, rx_account.deliver_launches = saved
    return out


def run_shared(boot, sc, rx_account, settings=None):
    """``simulate`` of a booted scenario, timed by CUDA events, with the
    host reads and both kernels' launches counted (zeroed just before):
    ``(out, ms_per_tick, reads_per_tick, launches, peak_bytes)``."""
    import torch
    from rapid_tpu_torch import device as device_mod
    from rapid_tpu_torch.engine import simulate

    settings = sc.settings() if settings is None else settings
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reads = device_mod.host_reads
    zero_counts(rx_account)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = simulate(boot.state, boot.faults, sc.ticks, settings,
                   churn=boot.churn, fallback=boot.fallback)
    end.record()
    end.synchronize()
    launches = rx_account.deliver_launches + rx_account.launches
    return (out, start.elapsed_time(end) / sc.ticks,
            (device_mod.host_reads - reads) / sc.ticks, launches,
            torch.cuda.max_memory_allocated())


def check_golden(sc, rec: dict, label: str) -> None:
    from rapid_tpu_torch import golden

    diff_ = golden.differences(rec, golden.load(sc.path))
    if diff_:
        raise AssertionError(f"{label} differs from its golden file in "
                             f"{diff_[:8]}")


def phase_shared(sc, phase: int, device, rx_account, keep=None) -> dict:
    """One golden scenario (a name of ``golden.SCENARIOS`` or a
    ``SharedScenario``) through the shared engine's entry points, with
    both kernels' launch counts zeroed just before the run and read after
    (the shared engine has no kernel: any launch fails the phase)."""
    from rapid_tpu_torch import golden
    from rapid_tpu_torch.engine import diff

    sc = golden.SCENARIOS[sc] if isinstance(sc, str) else sc
    boot = sc.boot(device=device)
    out, ms_tick, reads, launches, peak = run_shared(boot, sc, rx_account)
    if launches:
        raise AssertionError(f"{sc.name} launched a delivery kernel "
                             f"{launches} times")
    logs = out[1]
    if keep is not None:
        keep[sc.name] = logs
    rec = golden.shared_run_record(sc.name, *out, plan=boot.plan)
    check_golden(sc, rec, sc.name)
    phases = diff.expand_fallback_counters(logs)
    decides = [(e["tick"], len(e["slots"])) for e in rec["events"]
               if e["kind"] == "view_change"]
    # A classic decide lands with the phase-2b messages.
    classic = [t for t, _ in decides if phases[t - 1]["phase2b_delivered"]]
    totals = {key: sum(row[key] for row in phases) for key in phases[0]
              if key.endswith("_sent")}
    flags = [f for f, on in (("variant " + sc.variant, sc.variant != "rapid"),
                             ("invariant_checks", sc.invariant_checks),
                             (f"W={sc.recorder_window}", sc.recorder_window))
             if on]
    log(f"phase {phase}: {sc.name}{' (' + ', '.join(flags) + ')' if flags else ''}"
        f" x {sc.ticks} ticks equals its golden file: {ms_tick:.3f} ms/tick, "
        f"{reads:.3f} host reads/tick, peak {peak / 2**20:.1f} MiB, setup "
        f"{boot.setup_s:.2f} s, decides {decides}, {len(classic)} by the "
        f"classic round, {rec['log']['n_member'][-1]} members at the end, "
        f"{launches} launches of rx_deliver and rx_account")
    if boot.fallback is not None:
        log(f"phase {phase}: consensus messages sent by phase {totals}")
    return {"n": sc.n, "ticks": sc.ticks, "ms_per_tick": ms_tick,
            "host_reads_per_tick": reads, "peak_bytes": peak,
            "setup_s": boot.setup_s, "plan_s": boot.plan_s,
            "decides": decides, "classic_decides": classic,
            "phase_sent": totals, "n_member": rec["log"]["n_member"][-1],
            "kernel_launches": launches, "log": rec["log"],
            "stamps": rec.get("recorder", {}).get("stamps")}


#: StepLog message factors the variants change.
FACTORS = ("vote_senders", "vote_recipients", "vote_senders_alive",
           "vote_deliver_alive", "flushers", "flushers_alive")


def print_factors(phase: int, name: str, run: dict, plain: dict) -> None:
    """The variant's message factors beside phase 7's: their sums over the
    run and their values on the announce and decide ticks."""
    lg, pl = run.pop("log"), plain["log"]
    announce = lg["announce_now"].index(1)
    decide = lg["decide_now"].index(1)
    rows = {f: {"sum": sum(lg[f]), "announce": lg[f][announce],
                "decide": lg[f][decide], "rapid_sum": sum(pl[f]),
                "rapid_announce": pl[f][announce],
                "rapid_decide": pl[f][decide]} for f in FACTORS}
    if all(r["sum"] == r["rapid_sum"] for r in rows.values()):
        raise AssertionError(f"{name} logs rapid's message factors")
    log(f"phase {phase}: {name} message factors (ticks {announce + 1} "
        f"announce, {decide + 1} decide) beside phase 7's: "
        f"{json.dumps(rows)}")
    run["factors"] = rows


def option_in_turns(on_sc, off_sc, boot, rounds: int, rx_account) -> dict:
    """ms/tick of one boot run as ``on_sc`` (an option on) and ``off_sc``
    (off), in turns (off, on, on, off per round); every run equals its
    scenario's golden file."""
    from rapid_tpu_torch import golden

    times = {"off": [], "on": []}
    for _ in range(rounds):
        for which in ("off", "on", "on", "off"):
            sc = on_sc if which == "on" else off_sc
            out, ms_tick, _, launches, _ = run_shared(boot, sc, rx_account)
            if launches:
                raise AssertionError(f"{sc.name} launched a kernel")
            check_golden(sc, golden.shared_run_record(sc.name, *out),
                         f"{sc.name} (option {which}, in turns)")
            times[which].append(ms_tick)
    return times


def print_turns(phase: int, label: str, times: dict) -> None:
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    log(f"phase {phase}: {label} in turns, ms/tick off {times['off']} "
        f"(mean {mean['off']:.3f}), on {times['on']} (mean "
        f"{mean['on']:.3f}): the option costs "
        f"{mean['on'] - mean['off']:+.3f} ms/tick "
        f"({100 * (mean['on'] / mean['off'] - 1):+.1f} %)")


def phase_monitor(device, rx_account) -> dict:
    """Phase 13: phases 7 and 10 with ``invariant_checks=True``, equal to
    their golden files (every ``inv_bits`` 0), each in turns with the
    monitor off; then a memsum limb corrupted at boot flags bit 5 from
    tick 1 and ``check_run`` names tick 1."""
    import dataclasses

    import torch
    from rapid_tpu_torch import golden
    from rapid_tpu_torch.engine import invariants, simulate
    from rapid_tpu_torch.hashing import MASK32

    out = {}
    for name in ("shared_n100k_crash", "shared_n100k_contested"):
        sc = dataclasses.replace(golden.SHARED[name], invariant_checks=True)
        run = phase_shared(sc, 13, device, rx_account)
        if set(run.pop("log")["inv_bits"]) != {0}:
            raise AssertionError(f"{name}: the monitor flagged a clean run")
        boot = sc.boot(device=device)
        run["in_turns"] = option_in_turns(sc, golden.SHARED[name], boot,
                                          TURN_ROUNDS, rx_account)
        print_turns(13, f"{name} with the monitor", run["in_turns"])
        out[name] = run
    sc = dataclasses.replace(golden.SHARED["shared_n100k_crash"],
                             invariant_checks=True)
    boot = sc.boot(device=device)
    state = boot.state._replace(memsum_lo=(boot.state.memsum_lo + 1)
                                & MASK32)
    zero_counts(rx_account)
    _, logs = simulate(state, boot.faults, 4, sc.settings())
    memsum = 1 << invariants.BIT_OF["memsum"]
    rows = invariants.expand_violations(logs)
    if rows != [(t, memsum, ["memsum"]) for t in range(1, 5)]:
        raise AssertionError(f"memsum corruption flagged {rows}")
    try:
        invariants.check_run(logs)
    except invariants.InvariantViolationError as err:
        if err.report.tick != 1 or "tick 1" not in str(err):
            raise AssertionError(f"check_run named {err.report.tick}")
        log(f"phase 13: memsum limb corrupted at boot (N=100,000): bit 5 "
            f"on ticks 1-4, check_run raised {str(err).splitlines()[0]!r}")
    else:
        raise AssertionError("check_run let the corrupted run pass")
    torch.cuda.synchronize()
    return out


def receiver_recorder_runs(rx_account, device, keep: dict) -> dict:
    """Phase 14's receiver half: the N=1024 main-path run with a 64-row
    recorder, equal to ``rx_n1024_recorder.json`` (counters, events,
    config ids, ring rows and stamps), ``rx_deliver`` 6 times a tick and
    ``rx_account`` never, the final state and logs equal to the run
    without the recorder; then one run without it and one with it."""
    import torch
    from rapid_tpu_torch import device as device_mod
    from rapid_tpu_torch import golden
    from rapid_tpu_torch.engine import receiver, recorder
    from rapid_tpu_torch.faults import crash_window_delay_schedule
    from rapid_tpu_torch.settings import Settings

    run = golden.RX_RECORDERS[-1]
    n, ticks = run.n, golden.GOLDEN_TICKS
    on = Settings(rx_kernel="pallas", flight_recorder_window=run.window)
    off = Settings(rx_kernel="pallas")
    member = receiver.lower_receiver_schedule(crash_window_delay_schedule(n),
                                              on, device=device)
    want = golden.load(run.path)
    first = {}
    times = {"off": [], "on": []}
    for which in ("on", "off", "on"):
        settings = on if which == "on" else off
        zero_counts(rx_account)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reads = device_mod.host_reads
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = receiver.receiver_simulate(member.state, member.faults, ticks,
                                         settings)
        end.record()
        end.synchronize()
        counts = (rx_account.deliver_launches, rx_account.launches)
        if counts != (6 * ticks, 0):
            raise AssertionError(f"receiver W={settings.flight_recorder_window}"
                                 f" launched (rx_deliver, rx_account) "
                                 f"{counts}, want {(6 * ticks, 0)}")
        receiver.check_flags(got[0].flags)
        if not first:
            rec = golden.run_record(got[0], got[1], n)
            rec["recorder"] = keep["rx_recorder"] = \
                recorder.recorder_payload(got[2])
            diff_ = golden.differences(rec, want)
            if diff_:
                raise AssertionError(f"N={n} recorder run differs from "
                                     f"its golden file in {diff_[:8]}")
            first = {"final": got[0], "logs": got[1],
                     "stamps": recorder.stamps(got[2]), "launches": counts,
                     "ms_per_tick": start.elapsed_time(end) / ticks,
                     "host_reads_per_tick":
                         (device_mod.host_reads - reads) / ticks,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
            continue
        if not (same_run(first["final"], got[0])
                and same_run(first["logs"], got[1])):
            raise AssertionError(f"receiver run with the recorder {which} "
                                 "differs from the first recorder run")
        times[which].append(start.elapsed_time(end) / ticks)
    log(f"phase 14: N={n} x {ticks} ticks with W={on.flight_recorder_window} "
        f"equals {run.path.name} (rows and stamps "
        f"{first['stamps']}), rx_deliver {first['launches'][0]} launches, "
        f"rx_account {first['launches'][1]}, {first['ms_per_tick']:.2f} "
        f"ms/tick, {first['host_reads_per_tick']:.3f} host reads/tick, peak "
        f"{first['peak_bytes'] / 2**20:.1f} MiB; the runs without the "
        f"recorder equal it")
    print_turns(14, f"N={n} receiver with the recorder", times)
    return {"stamps": first["stamps"], "deliver_launches":
            first["launches"][0], "account_launches": first["launches"][1],
            "ms_per_tick": first["ms_per_tick"],
            "host_reads_per_tick": first["host_reads_per_tick"],
            "peak_bytes": first["peak_bytes"], "in_turns": times}


def phase_recorder(device, rx_account, keep: dict) -> dict:
    """Phase 14: a 64-row recorder on phase 7's run and on phase 4's
    N=1024 receiver run."""
    from rapid_tpu_torch import golden

    sc = golden.OPTIONS["shared_n100k_crash_rec64"]
    shared = phase_shared(sc, 14, device, rx_account)
    shared.pop("log")
    boot = sc.boot(device=device)
    shared["in_turns"] = option_in_turns(
        sc, golden.SHARED["shared_n100k_crash"], boot, TURN_ROUNDS,
        rx_account)
    print_turns(14, "shared_n100k_crash with the recorder",
                shared["in_turns"])
    return {"shared": shared,
            "receiver": receiver_recorder_runs(rx_account, device, keep)}


PLANNED = ("shared_n100k_planned_churn", "shared_n10k_planned_mixed")


def phase_planned(device, rx_account) -> dict:
    """Phase 15, run in a child process under the pinned
    ``PYTHONHASHSEED``: ``plan_churn`` builds each schedule, then
    ``init_state(member=, id_fps=)`` and ``simulate(churn=)`` run it,
    equal to its golden file (the run and the planner's prediction)."""
    from rapid_tpu_torch import golden

    out = {}
    for name in PLANNED:
        # The child's first runs pay for loading the card's kernels: the
        # first run of each scenario is its cold one, a second run from
        # the same boot its warm one.
        run = phase_shared(name, 15, device, rx_account)
        run.pop("log")
        sc = golden.OPTIONS[name]
        boot = sc.boot(device=device)
        warm, ms_tick, reads, launches, _ = run_shared(boot, sc, rx_account)
        if launches:
            raise AssertionError(f"{name} launched a kernel")
        check_golden(sc, golden.shared_run_record(sc.name, *warm,
                                                  plan=boot.plan), name)
        run.update(cold_ms_per_tick=run.pop("ms_per_tick"),
                   ms_per_tick=ms_tick, plan_s_again=boot.plan_s)
        log(f"phase 15: {name}: plan_churn took {run['plan_s']:.2f} s and "
            f"{boot.plan_s:.2f} s, view changes {run['decides']}; a second "
            f"run from a new boot: {ms_tick:.3f} ms/tick ({reads:.3f} host "
            f"reads/tick), equal to the golden file")
        out[name] = run
    return out


def random_fleet(c: int, f: int, planes: int, seed: int, device):
    """Dense message planes of ``f`` members (``[F, C, C]`` for one plane,
    ``[F, B, C, C]`` for more), their packed blocked planes, crash masks
    and nonzero ``[F, 14]`` counters."""
    import torch
    from rapid_tpu_torch.engine.rx_packed import pack_bits

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)
    shape = (f, c, c) if planes == 1 else (f, planes, c, c)
    msgs = t(rng.random(shape) < 0.5)
    pe = pack_bits(t(rng.random((f, c, c)) < 0.2))
    crashed = t(rng.random((f, c)) < 0.1)
    acc = t(rng.integers(-9, 9, (f, 14)).astype(np.int32))
    return msgs, crashed, pe, acc


def fleet_bytes(c: int, f: int, planes: int) -> int:
    """Bytes one member-axis ``rx_deliver`` launch must move: each
    member's ``deliver_bytes`` plus its counter row (56 bytes) read."""
    return f * (deliver_bytes(c, planes) + 14 * 4)


def phase_fleet_deliver(rx_account, device) -> tuple:
    """Phase 16: ``rx_deliver`` over a member axis equals its plain
    version, then its times at F=256 against the byte bound and against
    F launches of one member."""
    import itertools

    import torch

    worst = 0
    saved = (rx_account.launches, rx_account.deliver_launches)
    for c in FLEET_WIDTHS:
        for f in FLEET_F:
            if f > 4 and c > 48:
                continue
            for planes in (1, 2):
                msgs, crashed, pe, acc = random_fleet(c, f, planes,
                                                      seed=c + f + planes,
                                                      device=device)
                for phase in (None, PHASE_SLOT):
                    acc_k, acc_p = acc.clone(), acc.clone()
                    got = rx_account.account_into_kernel(msgs, crashed, pe,
                                                         acc_k, phase)
                    want = rx_account.account_into_plain(msgs, crashed, pe,
                                                         acc_p, phase)
                    torch.cuda.synchronize()
                    err = max(int((got.int() - want.int()).abs().max()),
                              int((acc_k - acc_p).abs().max()))
                    worst = max(worst, err)
                    if err:
                        raise AssertionError(
                            f"rx_deliver over F={f} != plain at C={c}, "
                            f"B={planes}, phase={phase}: max |diff| {err}")
        log(f"phase 16: rx_deliver C={c} over F in "
            f"{[f for f in FLEET_F if f <= 4 or c <= 48]} x B in (1, 2) == "
            f"plain (deliv and every member's counters, with and without a "
            f"phase slot)")
    times = {}
    f = FLEET_MEMBERS
    for c in (32, 48):
        msgs, crashed, pe, acc = random_fleet(c, f, 1, seed=c, device=device)
        args = (msgs, crashed, pe, acc, PHASE_SLOT)
        fused = lambda: rx_account.account_into_kernel(*args)
        rows = [(msgs[i], crashed[i], pe[i], acc[i]) for i in range(f)]
        apart = lambda: [rx_account.account_into_kernel(*r, PHASE_SLOT)
                         for r in rows]
        read = f * (c * c + c * -(-c // 8) + c + 56)
        count = -(-2 * L2_BYTES // read)
        sets = itertools.cycle([random_fleet(c, f, 1, seed=100 + k,
                                             device=device)[:3]
                                for k in range(count)])
        kept = []
        cold = graph_ms(lambda: kept.append(rx_account.account_into_kernel(
            *next(sets), acc, PHASE_SLOT)), iters=count)
        kept.clear()
        times[c] = {"ms": graph_ms(fused), "cold_ms": cold,
                    "plain_ms": graph_ms(lambda: rx_account.account_into_plain(
                        *args)),
                    "f_launches_ms": graph_ms(apart, iters=4),
                    "bound_ms": fleet_bytes(c, f, 1) / HBM_BYTES_PER_S * 1e3,
                    "call_ms": cuda_ms(fused, 200)}
        t = times[c]
        log(f"phase 16: rx_deliver F={f} C={c} B=1: {t['ms'] * 1e3:.3f} us "
            f"L2-warm, {t['cold_ms'] * 1e3:.3f} us L2-cold ({count} input "
            f"sets, {count * read / L2_BYTES:.2f} x L2), bound "
            f"{t['bound_ms'] * 1e3:.3f} us, {f} launches of one member "
            f"{t['f_launches_ms'] * 1e3:.3f} us, plain "
            f"{t['plain_ms'] * 1e3:.2f} us, {t['call_ms'] * 1e3:.2f} us per "
            f"eager call")
    rx_account.launches, rx_account.deliver_launches = saved
    return worst, times


def fleet_run(pool, members, device, ticks=None, rx_kernel="pallas"):
    """Lower and stack ``members`` of ``pool``, then run them with CUDA
    events around the run and both kernels' launches and the host reads
    counted (zeroed just before): ``(out, stats)``."""
    import torch
    from rapid_tpu_torch import device as device_mod
    from rapid_tpu_torch import golden
    from rapid_tpu_torch.engine import fleet, rx_account

    start = time.perf_counter()
    stacked = golden.lower_pool(pool, members, device=device,
                                rx_kernel=rx_kernel)
    torch.cuda.synchronize()
    setup = time.perf_counter() - start
    run = (fleet.fleet_simulate if pool.mode == "shared"
           else fleet.receiver_fleet_simulate)
    ticks = ticks or golden.FLEET_CAMPAIGN["ticks"]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rx_account)
    reads = device_mod.host_reads
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    out = run(stacked, ticks, golden.pool_settings(pool, rx_kernel),
              device=device)
    end.record()
    end.synchronize()
    ms = begin.elapsed_time(end)
    return out, {"f": len(members), "ticks": ticks, "setup_s": setup,
                 "ms_per_tick": ms / ticks,
                 "ms_per_member_tick": ms / ticks / len(members),
                 "host_reads_per_tick": (device_mod.host_reads - reads) / ticks,
                 "deliver_launches": rx_account.deliver_launches,
                 "account_launches": rx_account.launches,
                 "peak_bytes": torch.cuda.max_memory_allocated(),
                 "run_peak_bytes": torch.cuda.max_memory_allocated() - base}


def fleet_profile(pool, members, device, rx_kernel="pallas") -> dict:
    """Kernels, aten ops and host reads per tick of a pool's fleet over
    ``FLEET_PROFILE_TICKS`` ticks from its boot, under ``torch.profiler``."""
    from rapid_tpu_torch import golden, profile
    from rapid_tpu_torch.engine import fleet

    stacked = golden.lower_pool(pool, members, device=device,
                                rx_kernel=rx_kernel)
    run = (fleet.fleet_simulate if pool.mode == "shared"
           else fleet.receiver_fleet_simulate)
    settings = golden.pool_settings(pool, rx_kernel)
    field = "decide_now" if pool.mode == "shared" else "decide"

    def window():
        out = run(stacked, FLEET_PROFILE_TICKS, settings, device=device)
        return getattr(out[1], field)

    return profile.profile_window(window, FLEET_PROFILE_TICKS, 5,
                                  {"pool": pool.pool_id, "f": len(members)})


def phase_fleet_pools(device) -> dict:
    """Phase 17, the main path: each pool's 256 members lowered by the
    port from its golden file's schedules, run on the card and equal to
    the file for every member."""
    from rapid_tpu_torch import golden

    out, outputs = {}, {}
    for pool_id, pool in sorted(golden.FLEET_POOLS.items()):
        want = golden.load(pool.path)
        members = golden.pool_inputs(want)
        res, stats = fleet_run(pool, members, device)
        outputs[pool_id] = res
        want_launches = (6 * stats["ticks"]
                         if pool.mode == "per_receiver" else 0)
        if (stats["deliver_launches"], stats["account_launches"]) != \
                (want_launches, 0):
            raise AssertionError(
                f"pool {pool_id} launched (rx_deliver, rx_account) "
                f"{(stats['deliver_launches'], stats['account_launches'])},"
                f" want {(want_launches, 0)}")
        diff_ = golden.differences(golden.fleet_run_record(pool, members,
                                                           res), want)
        if diff_:
            raise AssertionError(f"pool {pool_id} differs from its golden "
                                 f"file in {diff_[:8]}")
        prof = fleet_profile(pool, members, device)
        decides = sum(len([e for e in m["events"] if e[1] == "view_change"])
                      for m in want["members"])
        stats.update(profile=prof, view_change_events=decides)
        out[pool_id] = stats
        log(f"phase 17: pool {pool_id} ({pool.mode}, C={pool.capacity}, "
            f"{'/'.join(pool.kinds)}) F={stats['f']} x {stats['ticks']} "
            f"ticks equals its golden file for every member: "
            f"{stats['ms_per_tick']:.3f} ms/tick, "
            f"{stats['ms_per_member_tick'] * 1e3:.2f} us/member-tick, "
            f"{stats['host_reads_per_tick']:.3f} host reads/tick, "
            f"{prof['device_kernels_per_tick']:.1f} kernels/tick and "
            f"{prof['device_busy_ms_per_tick']:.3f} ms/tick device-busy over "
            f"ticks 1-{FLEET_PROFILE_TICKS}, peak "
            f"{stats['peak_bytes'] / 2**20:.1f} MiB "
            f"({stats['run_peak_bytes'] / 2**20:.1f} above the run's "
            f"start), setup "
            f"{stats['setup_s']:.2f} s, {stats['deliver_launches']} "
            f"rx_deliver launches, {decides} view-change events")
    return out, outputs


def single_member_run(pool, member: dict, device) -> tuple:
    """``member`` of ``pool`` through the one-cluster entry points
    (``simulate``, ``receiver_simulate``), timed by CUDA events: its
    ``golden.pool_record`` and ms per tick."""
    import torch
    from rapid_tpu_torch import golden
    from rapid_tpu_torch.convert import to_numpy
    from rapid_tpu_torch.engine import fleet, receiver, simulate

    one = fleet.member_of(golden.lower_pool(pool, [member], device=device),
                          0)
    settings = golden.pool_settings(pool)
    ticks = golden.FLEET_CAMPAIGN["ticks"]
    torch.cuda.synchronize()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    if pool.mode == "shared":
        final, logs, rec = simulate(one.state, one.faults, ticks, settings,
                                    churn=one.churn, fallback=one.fallback)
    else:
        dense, logs = receiver.receiver_simulate(one.state, one.faults,
                                                 ticks, settings)
        final = receiver.receiver_final_fields(dense)
        rec = None
    end.record()
    end.synchronize()
    axis = lambda nt: None if nt is None else to_numpy(
        type(nt)(*[leaf[None] for leaf in nt]))
    record = golden.pool_record(pool, [member], axis(logs), axis(final),
                                axis(rec))
    return record, begin.elapsed_time(end) / ticks


def phase_fleet_scaling(device, full: dict) -> dict:
    """Phase 18: pools 0 and 3 at F in ``SCALE_F`` (prefixes of the same
    members) for ``SCALE_TICKS`` ticks, each F once, each
    run's logs equal to the first F members' first ticks of phase 17's
    run (``full``), and member 0 through the one-cluster path, equal to
    its golden entry."""
    import torch
    from rapid_tpu_torch import golden

    out = {}
    for pool_id in (0, 3):
        pool = golden.FLEET_POOLS[pool_id]
        want = golden.load(pool.path)
        inputs = golden.pool_inputs(want)
        runs = {f: [] for f in SCALE_F}
        reads = {}
        for f in SCALE_F:
            res, stats = fleet_run(pool, inputs[:f], device, SCALE_TICKS)
            ref_logs = full[pool_id][1]
            for name, got in zip(res[1]._fields, res[1]):
                if not torch.equal(got, getattr(ref_logs, name)[
                        :f, :SCALE_TICKS]):
                    raise AssertionError(f"pool {pool_id} F={f}: {name} "
                                         f"differs from phase 17's run")
            runs[f].append(stats["ms_per_member_tick"])
            reads[f] = stats["host_reads_per_tick"]
        record, single_ms = single_member_run(pool, inputs[0], device)
        if golden.differences(golden.pool_head(record, 1),
                              golden.pool_head(want, 1)):
            raise AssertionError(f"pool {pool_id} member 0 alone differs "
                                 f"from its golden entry")
        out[pool_id] = {"ms_per_member_tick": runs,
                        "host_reads_per_tick": reads,
                        "single_member_ms_per_tick": single_ms}
        log(f"phase 18: pool {pool_id}, {SCALE_TICKS} ticks, ms per "
            f"member-tick by F: "
            f"{ {f: [round(t, 5) for t in v] for f, v in runs.items()} }, "
            f"host reads/tick {reads}, every run's logs equal to phase "
            f"17's; member 0 alone through the one-cluster path, 120 "
            f"ticks: {single_ms:.3f} ms/tick, equal to its entry")
    return out


def layout_run(member, settings, ticks: int, rx_account, want, label):
    """``receiver_simulate`` of ``member`` under ``settings``, timed by
    CUDA events with the launches and host reads counted (zeroed just
    before) and the peak memory above what was allocated before it;
    equal to ``want`` (final, logs), ``rx_deliver`` 6 launches a tick and
    ``rx_account`` none. Returns ``(final, logs, stats)``."""
    import torch
    from rapid_tpu_torch import device as device_mod
    from rapid_tpu_torch.engine import receiver

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rx_account)
    reads = device_mod.host_reads
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    final, logs = receiver.receiver_simulate(member.state, member.faults,
                                             ticks, settings)
    end.record()
    end.synchronize()
    stats = {"ms_per_tick": begin.elapsed_time(end) / ticks,
             "host_reads_per_tick": (device_mod.host_reads - reads) / ticks,
             "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
             "run_peak_mib": (torch.cuda.max_memory_allocated() - base)
             / 2**20,
             "launches": (rx_account.deliver_launches, rx_account.launches)}
    if stats["launches"] != (6 * ticks, 0):
        raise AssertionError(f"{label} launched (rx_deliver, rx_account) "
                             f"{stats['launches']}, want {(6 * ticks, 0)}")
    receiver.check_flags(final.flags)
    if want is not None and not (same_run(final, want[0])
                                 and same_run(logs, want[1])):
        raise AssertionError(f"{label} differs from the run it is held to")
    return final, logs, stats


def phase_layouts(rx_account, device, keep: dict, main_run: dict) -> dict:
    """Phase 19: phase 4's run under the dense and the packed carry, one
    run each, every run equal to phase 4's; then each one's kernels per
    tick over ticks 106-113 under ``torch.profiler``. Phase 4 runs
    ``"pallas"``, which shares the packed code: its entry is phase 4's
    run and window."""
    from rapid_tpu_torch import profile, tick_time
    from rapid_tpu_torch.engine import receiver, rx_packed
    from rapid_tpu_torch.faults import crash_window_delay_schedule
    from rapid_tpu_torch.settings import Settings

    n, ticks = tick_time.N, tick_time.TICKS
    schedule = crash_window_delay_schedule(n)
    layouts = ("xla", "packed")
    settings = {k: Settings(rx_kernel=k) for k in layouts}
    members = {k: receiver.lower_receiver_schedule(schedule, settings[k],
                                                   device=device)
               for k in layouts}
    if not isinstance(members["xla"].state, receiver.ReceiverState):
        raise AssertionError("Settings() did not lower a dense member")
    runs = {}
    for k in layouts:
        _, _, runs[k] = layout_run(members[k], settings[k], ticks,
                                   rx_account, keep["main"], f"phase 19 {k}")
    zero_counts(rx_account)
    windows = {}
    for k in layouts:
        state = tick_time.timed(members[k], settings[k],
                                ticks=tick_time.WINDOW_FROM)[0]
        if k != "xla":
            state = rx_packed.bundle_from_dense(state, settings[k])
        windows[k] = profile.profile_window(
            lambda k=k, state=state: tick_time.timed(
                members[k], settings[k], None, state,
                PROFILE_TICKS)[1].decide, PROFILE_TICKS, 5, {"layout": k})
    zero_counts(rx_account)
    out = {}
    for k in layouts:
        r, w = runs[k], windows[k]
        out[k] = {"ms_per_tick": r["ms_per_tick"],
                  "host_reads_per_tick": r["host_reads_per_tick"],
                  "peak_mib": r["peak_mib"],
                  "run_peak_mib": r["run_peak_mib"],
                  "deliver_launches": r["launches"][0], "window": w}
        log(f"phase 19: N={n} x {ticks} ticks under rx_kernel={k!r} equals "
            f"phase 4's run: {r['ms_per_tick']:.3f} ms/tick, "
            f"{r['host_reads_per_tick']:.3f} host reads/tick, peak "
            f"{r['peak_mib']:.1f} MiB ({r['run_peak_mib']:.1f} above "
            f"the run's start), {r['launches'][0]} rx_deliver launches, 0 "
            f"rx_account; ticks 106-{105 + PROFILE_TICKS} under "
            f"torch.profiler: {w['device_kernels_per_tick']:.1f} "
            f"kernels/tick, {w['aten_ops_per_tick']:.1f} aten ops/tick, "
            f"{w['device_busy_ms_per_tick']:.3f} ms/tick device-busy")
    out["pallas"] = {"ms_per_tick": main_run["ms_per_tick"],
                     "deliver_launches": main_run["deliver_launches"],
                     "window": main_run["profile"]["default"]}
    log(f"phase 19: rx_kernel='pallas' is phase 4's run "
        f"({main_run['ms_per_tick']:.3f} ms/tick, "
        f"{main_run['deliver_launches']} rx_deliver launches)")
    return out


def phase_wide_dense(rx_account, device) -> dict:
    """Phase 20: phase 5's N=4096 partition under "xla", in turns with
    "pallas" (xla, pallas, pallas, xla), phase 5's checks on every run
    and every run equal to the first."""
    from rapid_tpu_torch.engine import fleet, receiver
    from rapid_tpu_torch.settings import Settings

    schedule = wide_schedule()
    first = None
    out = {"xla": [], "pallas": []}
    for k in ("xla", "pallas", "pallas", "xla"):
        settings = Settings(rx_kernel=k)
        member = receiver.lower_receiver_schedule(schedule, settings,
                                                  device=device)
        final, logs, stats = layout_run(member, settings, WIDE_TICKS,
                                        rx_account, first, f"phase 20 {k}")
        check_wide(rx_account, final, logs)
        if first is None:
            first = (final, logs)
        out[k].append(stats)
        del member
    del first
    fleet.clear_boot_caches()       # the N=4096 boots of both layouts
    zero_counts(rx_account)
    for k, runs in out.items():
        ms = [round(r["ms_per_tick"], 2) for r in runs]
        log(f"phase 20: N={WIDE_N} x {WIDE_TICKS} ticks under "
            f"rx_kernel={k!r}: ms/tick {ms}, "
            f"peak {max(r['peak_mib'] for r in runs) / 1024:.2f} GiB "
            f"({max(r['run_peak_mib'] for r in runs) / 1024:.2f} above the "
            f"run's start), every run equal to the first")
    return {k: {"ms_per_tick": [r["ms_per_tick"] for r in runs],
                "peak_mib": max(r["peak_mib"] for r in runs),
                "run_peak_mib": max(r["run_peak_mib"] for r in runs)}
            for k, runs in out.items()}


def phase_dense_fleets(device, packed: dict) -> dict:
    """Phase 21: pools 2 and 3 lowered on the dense carry, F=256, equal to
    their golden files, beside phase 17's packed runs (``packed``)."""
    from rapid_tpu_torch import golden
    from rapid_tpu_torch.engine.state import ReceiverState

    out = {}
    for pool_id in (2, 3):
        pool = golden.FLEET_POOLS[pool_id]
        want = golden.load(pool.path)
        members = golden.pool_inputs(want)
        res, stats = fleet_run(pool, members, device, rx_kernel="xla")
        if not isinstance(res[0], ReceiverState):
            raise AssertionError(f"pool {pool_id}: the finals are not "
                                 f"dense")
        want_launches = 6 * stats["ticks"]
        if (stats["deliver_launches"], stats["account_launches"]) != \
                (want_launches, 0):
            raise AssertionError(
                f"pool {pool_id} (xla) launched (rx_deliver, rx_account) "
                f"{(stats['deliver_launches'], stats['account_launches'])}")
        diff_ = golden.differences(golden.fleet_run_record(pool, members,
                                                           res), want)
        if diff_:
            raise AssertionError(f"pool {pool_id} (xla) differs from its "
                                 f"golden file in {diff_[:8]}")
        del res
        prof = fleet_profile(pool, members, device, rx_kernel="xla")
        stats["profile"] = prof
        out[pool_id] = stats
        p = packed[pool_id]
        log(f"phase 21: pool {pool_id} under rx_kernel='xla' F={stats['f']} "
            f"x {stats['ticks']} ticks equals its golden file: "
            f"{stats['ms_per_tick']:.3f} ms/tick "
            f"({stats['ms_per_member_tick'] * 1e3:.2f} us/member-tick; "
            f"phase 17 packed {p['ms_per_tick']:.3f}, "
            f"{p['ms_per_member_tick'] * 1e3:.2f}), "
            f"{prof['device_kernels_per_tick']:.1f} kernels/tick over ticks "
            f"1-{FLEET_PROFILE_TICKS} (packed "
            f"{p['profile']['device_kernels_per_tick']:.1f}), peak "
            f"{stats['run_peak_bytes'] / 2**20:.1f} MiB above the run's "
            f"start (packed {p['run_peak_bytes'] / 2**20:.1f}; "
            f"{stats['peak_bytes'] / 2**20:.1f} and "
            f"{p['peak_bytes'] / 2**20:.1f} in all), "
            f"{stats['host_reads_per_tick']:.3f} host reads/tick, "
            f"{stats['deliver_launches']} rx_deliver "
            f"launches")
    return out


def phase_telemetry(keep: dict, pool_outputs: dict) -> dict:
    """Phase 22: the port's telemetry folds of the card's logs equal the
    reference's folds in ``telemetry_golden.json`` and pass the port's
    validators; one Perfetto trace of phase 7's logs loads back."""
    import tempfile

    from rapid_tpu_torch import golden
    from rapid_tpu_torch.engine import receiver
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.telemetry import trace

    want = golden.load(golden.TELEMETRY_PATH)["entries"]
    folds = golden.port_folds()
    seconds = {}

    def held(name, fold):
        start = time.perf_counter()
        got = fold()
        seconds[name] = time.perf_counter() - start
        got = json.loads(golden.dumps(got))
        diff_ = golden.differences(got, want[name])
        if diff_:
            raise AssertionError(f"phase 22: {name} folds differ from the "
                                 f"reference's in {diff_[:8]}")
        if got["errors"]:
            raise AssertionError(f"phase 22: {name}: {got['errors'][:4]}")
        return got

    for name in golden.TELEMETRY_SHARED:
        held(name, lambda name=name: golden.shared_telemetry(folds,
                                                             keep[name]))
    held("rx_n1024_recorder",
         lambda: golden.recorder_telemetry(folds, keep["rx_recorder"]))
    for pool_id in golden.TELEMETRY_POOLS:
        pool = golden.FLEET_POOLS[pool_id]
        members = golden.pool_inputs(golden.load(pool.path))
        res = pool_outputs[pool_id]
        finals = (None if pool.mode == "shared"
                  else receiver.receiver_final_fields(res[0]))
        held(f"fleet_pool{pool_id}", lambda: golden.pool_telemetry(
            folds, pool, members, res[1], finals))
    log(f"phase 22: the port's folds of phases 7, 9, 10, 14 (N=1024 "
        f"recorder) and 17 (pools 0, 2) equal telemetry_golden.json and "
        f"pass the port's validators; host seconds per fold "
        f"{ {k: round(v, 4) for k, v in seconds.items()} }")

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        start = time.perf_counter()
        writer = trace.TraceWriter()
        with trace.wall_span(writer, "fold", {"phase": 22}):
            trace.trace_from_logs(keep["shared_n100k_crash"], Settings(),
                                  writer=writer)
        writer.write(path)
        seconds["trace"] = time.perf_counter() - start
        with open(path, "rb") as fh:
            raw = fh.read()
    events = json.loads(raw)["traceEvents"]
    slices = {e["name"] for e in events
              if e["ph"] == "B" and e["pid"] == trace.VIRTUAL_PID}
    instants = {(e["name"], e["args"]["tick"]) for e in events
                if e["ph"] == "i"}
    ends = sum(e["ph"] == "E" for e in events)
    begins = sum(e["ph"] == "B" for e in events)
    if not raw.endswith(b"\n") or begins != ends or \
            not {"decide", "deliver", "flush", "monitor",
                 "proposal 0"} <= slices or \
            not {("proposal", 112), ("view_change", 113)} <= instants or \
            [e["ts"] for e in events] != sorted(e["ts"] for e in events):
        raise AssertionError(f"phase 22: the trace of phase 7 is malformed "
                             f"({begins} B, {ends} E, {sorted(slices)})")
    log(f"phase 22: Perfetto trace of phase 7's logs: {len(raw)} bytes, "
        f"{len(events)} events, {begins} slices, phase slices "
        f"{sorted(slices)}, proposal at 112 and view change at 113; "
        f"written and loaded in {seconds['trace']:.3f} s")
    return {"fold_seconds": seconds, "trace_bytes": len(raw),
            "trace_events": len(events)}


def engine_side(res) -> dict:
    """The device side of a receiver differential, in plain values."""
    from rapid_tpu_torch.convert import plain

    return plain({"events": [[(e.tick, e.kind, e.config_id, e.slots)
                              for e in evs]
                             for evs in res.engine_events_by_slot],
                  "counters": res.engine_counters,
                  "phases": res.engine_phase_counters,
                  "config_ids": res.engine_config_ids})


def ended_delay_schedule(n: int):
    """The main path's scenario with its delay rule ended at tick 100,
    before the cut: its crashes and two-way window alone (the rule then
    holds back no message)."""
    import dataclasses

    from rapid_tpu_torch.faults import crash_window_delay_schedule

    main = crash_window_delay_schedule(n)
    return dataclasses.replace(main, delays=tuple(
        dataclasses.replace(r, end_tick=100) for r in main.delays))


def half_delay_schedule(n: int):
    """``tests/test_delay.py``'s delay family (slot n-1 crashing at tick
    11; delay 2, jitter 1, seed 41) with its rule widened from the first
    30 of 256 slots to the first half, toward every slot: alert batches
    and votes of half the senders arrive 2-3 ticks late, reordered
    against the other half's."""
    from rapid_tpu_torch.faults import AdversarySchedule, DelayRule

    return AdversarySchedule(
        n=n, crashes=((n - 1, 11),), seed=41,
        delays=(DelayRule(src_slots=frozenset(range(n // 2)),
                          dst_slots=frozenset(range(n)), delay_ticks=2,
                          jitter_ticks=1),))


def delayed_sends(schedule, ticks: int, settings, res) -> dict:
    """The sends of ``res``'s referee run that a delay rule held back,
    by message kind: the host engine run again, counting each send its
    rule delays, and checked to give ``res``'s referee counters."""
    from rapid_tpu_torch.engine import diff
    from rapid_tpu_torch.engine.adversary import AdversaryEngine
    from rapid_tpu_torch.faults import delay_of_slots
    from rapid_tpu_torch.identity import id_fingerprint
    from rapid_tpu_torch.oracle.membership_view import uid_of

    counts = {}

    class Counting(AdversaryEngine):
        def _send(self, src, dst, kind, payload):
            if delay_of_slots(self.schedule.delays, self.schedule.seed,
                              src, dst, self.now):
                counts[kind] = counts.get(kind, 0) + 1
            super()._send(src, dst, kind, payload)

    n = schedule.n
    run = Counting(schedule, [uid_of(e) for e in diff.default_endpoints(n)],
                   sum(id_fingerprint(x) for x in diff.default_node_ids(n))
                   & ((1 << 64) - 1), settings).run(ticks)
    if run.tick_history != res.oracle_counters:
        raise AssertionError("phase 23: the counting referee ran another "
                             "run")
    return counts


def referee_run(schedule, ticks: int, settings, rx_account, device,
                label: str):
    """``run_receiver_differential`` on the card, the kernels' launches
    counted from 0 around it: ``rx_deliver`` 6 a tick, ``rx_account``
    none. Returns the result and its numbers."""
    from rapid_tpu_torch.engine import diff

    zero_counts(rx_account)
    res = diff.run_receiver_differential(schedule, ticks, settings,
                                         device=device)
    launches = (rx_account.deliver_launches, rx_account.launches)
    zero_counts(rx_account)
    if launches != (6 * ticks, 0):
        raise AssertionError(f"phase 23 {label} launched (rx_deliver, "
                             f"rx_account) {launches}, want "
                             f"{(6 * ticks, 0)}")
    stats = {"referee_s": res.seconds["referee"],
             "engine_ms_per_tick": res.seconds["engine"] * 1e3 / ticks,
             "deliver_launches": launches[0]}
    log(f"phase 23: {label}: host referee {stats['referee_s']:.2f} s, "
        f"device run {stats['engine_ms_per_tick']:.2f} ms/tick (wall, with "
        f"its host reads), {launches[0]} rx_deliver launches, 0 rx_account")
    return res, stats


def phase_referee_receiver(rx_account, device, keep: dict) -> dict:
    """Phase 23: the host referee holds the per-receiver engine at the
    main path's width, under the dense and the packed carry."""
    from rapid_tpu_torch import tick_time
    from rapid_tpu_torch.engine import receiver
    from rapid_tpu_torch.faults import (
        AdversarySchedule, DelayRule, crash_window_delay_schedule)
    from rapid_tpu_torch.settings import Settings

    n, ticks = tick_time.N, tick_time.TICKS
    out = {}
    phase4 = receiver.receiver_run_payload(*keep["main"], n, ticks)
    want4 = {"events": phase4.events_by_slot, "counters": phase4.tick_history,
             "phases": phase4.phase_history,
             "config_ids": phase4.config_ids}
    for label, schedule, run_ticks in (
            ("main", crash_window_delay_schedule(n), ticks),
            ("ended_delay", ended_delay_schedule(n), ticks),
            ("half_delay", half_delay_schedule(n), HALF_DELAY_TICKS)):
        sides = []
        for kernel in ("xla", "packed"):
            name = f"{label} N={n} rx_kernel={kernel!r}"
            res, stats = referee_run(schedule, run_ticks,
                                     Settings(rx_kernel=kernel), rx_account,
                                     device, name)
            div = res.first_divergence()
            stats["first_divergence"] = None if div is None else [
                div.tick, div.field, div.engine, div.oracle]
            if label != "main":
                res.assert_identical()
                log(f"phase 23: {name}: assert_identical, every slot's "
                    f"events, counters, phase counters and config id equal "
                    f"to the referee's")
            elif stats["first_divergence"] != MAIN_REFEREE_DIVERGENCE:
                raise AssertionError(
                    f"phase 23: {name}: first divergence from the host "
                    f"referee {stats['first_divergence']}, the reference's "
                    f"engine gives {MAIN_REFEREE_DIVERGENCE}")
            else:
                log(f"phase 23: {name}: the referee finds the divergence "
                    f"the reference's own engine has on this scenario "
                    f"(ROADMAP.md Queue 3): tick {div.tick}, {div.field} "
                    f"{div.engine} on the card against {div.oracle}")
            sides.append(engine_side(res))
            out[f"{label}_{kernel}"] = stats
        if sides[0] != sides[1]:
            raise AssertionError(f"phase 23 {label}: the dense and the "
                                 f"packed runs differ")
        t0 = time.perf_counter()
        delayed = delayed_sends(schedule, run_ticks, Settings(), res)
        out[f"{label}_xla"]["delayed_sends"] = delayed
        log(f"phase 23: {label}: the dense and packed device runs equal "
            f"each other; the delay rule held back {delayed or 'no'} sends "
            f"by kind (counted on a second referee run, "
            f"{time.perf_counter() - t0:.2f} s)")
        if label == "half_delay" and not (delayed.get("batch")
                                          and delayed.get("vote")):
            raise AssertionError("phase 23: half_delay delayed no alert "
                                 "batch or no vote")
        if label == "main":
            from rapid_tpu_torch.convert import plain

            if sides[0] != plain(want4):
                raise AssertionError("phase 23: the differential's boot "
                                     "gives another run than phase 4's")
            log("phase 23: main: the device runs equal phase 4's run "
                "(lower_receiver_schedule's boot)")

    slow = AdversarySchedule(
        n=SLOW_N, crashes=((5, 11),), seed=9,
        delays=(DelayRule(src_slots=frozenset(range(SLOW_N - 16, SLOW_N)),
                          dst_slots=frozenset(range(SLOW_N)),
                          delay_ticks=40, start_tick=100),))
    name = f"slow voters N={SLOW_N}"
    res, stats = referee_run(slow, SLOW_TICKS,
                             Settings(delivery_ring_depth=48), rx_account,
                             device, name)
    res.assert_identical()
    totals = {p: sum(d[p] for d in res.engine_phase_counters)
              for p in ("phase1a_sent", "phase1b_sent", "phase2a_sent",
                        "phase2b_sent")}
    if min(totals.values()) < 1 or \
            sum(r.link_dropped for r in res.oracle_metrics) != 0:
        raise AssertionError(f"phase 23: {name} did not decide by the "
                             f"classic round from a slow link alone: "
                             f"{totals}")
    delayed = delayed_sends(slow, SLOW_TICKS,
                            Settings(delivery_ring_depth=48), res)
    log(f"phase 23: {name}: assert_identical, decided by the classic round "
        f"with no drop ({totals}); the delay rule held back {delayed} sends "
        f"by kind")
    out["slow_voters"] = dict(stats, phase_totals=totals,
                              delayed_sends=delayed)
    return out


def phase_referee_shared(rx_account, device) -> dict:
    """Phase 24: the full oracle cluster holds the shared engine at
    N=256."""
    from rapid_tpu_torch.engine import diff
    from rapid_tpu_torch.oracle.cluster import default_rng
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.types import NodeId

    n = SHARED_REFEREE_N
    burst = {5: 11, 100: 13, 200: 15, 250: 19}
    endpoints = diff.default_endpoints(n + 1)
    rng = default_rng(Settings(), endpoints[n])
    node_ids = diff.default_node_ids(n)
    node_ids[3] = NodeId(rng.getrandbits(64), rng.getrandbits(64))
    split = ([[0], [1]], {s: (6, s % 2) for s in range(n)},
             {s: (10 if s == 0 else 100) for s in range(n)})
    runs = {
        "crash_burst": (140, lambda: diff.run_differential(
            n, burst, 140, device=device),
            [("proposal", 122, (5, 100, 200, 250)),
             ("view_change", 123, (5, 100, 200, 250))]),
        "churn": (60, lambda: diff.run_churn_differential(
            n=n, capacity=n + 4, n_ticks=60,
            joins={s: 5 for s in range(n, n + 4)},
            leaves={11: 30, 42: 30, 197: 30}, device=device),
            [("proposal", 10, (256, 257, 258, 259)),
             ("view_change", 11, (256, 257, 258, 259)),
             ("proposal", 33, (11, 42, 197)),
             ("view_change", 34, (11, 42, 197))]),
        "identifier_redraw": (40, lambda: diff.run_churn_differential(
            n=n, capacity=n + 1, n_ticks=40, joins={n: 5},
            node_ids=node_ids, device=device),
            [("proposal", 12, (n,)), ("view_change", 13, (n,))]),
        "fallback": (30, lambda: diff.run_fallback_differential(
            n, *split, 30, device=device), None),
        "ring": (140, lambda: diff.run_variant_differential(
            n, burst, 140, "ring", device=device), None),
        "hier": (140, lambda: diff.run_variant_differential(
            n, burst, 140, "hier", device=device), None),
    }
    out = {}
    for name, (ticks, run, want) in runs.items():
        zero_counts(rx_account)
        res = run()
        launches = (rx_account.deliver_launches, rx_account.launches)
        if launches != (0, 0):
            raise AssertionError(f"phase 24 {name}: the shared engine "
                                 f"launched {launches}")
        res.assert_identical()
        got = [(e.kind, e.tick, e.slots) for e in res.engine_events]
        if want is not None and got != want:
            raise AssertionError(f"phase 24 {name}: events {got}")
        if not any(e.kind == "view_change" for e in res.engine_events):
            raise AssertionError(f"phase 24 {name}: nothing decided")
        sec = res.seconds
        stats = {"oracle_s": sec["oracle"], "plan_s": sec.get("plan"),
                 "engine_ms_per_tick": sec["engine"] * 1e3 / ticks,
                 "events": got}
        if name == "fallback":
            sent = {p: sum(c[f"{p}_sent"] for c in res.oracle_phase_counters)
                    for p in ("phase1a", "phase2b")}
            if res.plan_info["mode"] != "classic" or \
                    sent != {"phase1a": n, "phase2b": n * n}:
                raise AssertionError(f"phase 24 fallback: {res.plan_info}, "
                                     f"{sent}")
            stats["plan_info"] = {k: v for k, v in res.plan_info.items()
                                  if isinstance(v, (int, str))}
        out[name] = stats
        log(f"phase 24: {name} N={n} x {ticks} ticks: assert_identical "
            f"against the oracle cluster, events {got}; oracle "
            f"{sec['oracle']:.2f} s on the host"
            + (f", planner {sec['plan']:.3f} s" if "plan" in sec else "")
            + f", engine {stats['engine_ms_per_tick']:.2f} ms/tick (wall, "
            f"with its host reads), no kernel launched")
    return out


# --- phases 25-27: campaigns, replay, the committed payloads -------------

#: ``rx_deliver`` launches of the 4,096-cluster campaign: 11 per-receiver
#: dispatches of 120 ticks, 6 launches a tick.
CAMPAIGN_LAUNCHES = 11 * 120 * 6
#: The reference's ``replay_member(..., oracle=True)`` verdicts on
#: ``benchmarks/campaign_4096.json``'s exemplars 5:0 (contested,
#: ``run_adversarial_differential``) and 7:58 (delay,
#: ``run_receiver_differential``); ``tests/test_torch_replay.py`` backs
#: them with the reference.
REPLAY_ORACLE_VERDICTS = {"5:0": True, "7:58": True}

#: A copy of ``scripts/bench_compare.py``'s exact checks (that script
#: imports the reference): config keys, run-level protocol counts, the
#: telemetry's protocol keys, the whole ``campaign`` block and the
#: structural keys of ``dispatch_timeline``.
EXACT_CONFIG_KEYS = ("n", "ticks", "k", "clusters", "fleet_size", "capacity",
                     "chunk_ticks")
EXACT_RUN_KEYS = (
    "announcements", "decisions", "final_members", "crashed_nodes",
    "churn_bursts", "burst_size", "contested_instances",
    "ticks_to_first_decide", "messages_per_view_change",
    "events_injected", "joins", "leaves", "bursts", "chunks",
    "traffic", "ticks_to_view_change", "lineage", "checkpoint")
EXACT_TELEMETRY_KEYS = (
    "announcements", "decisions", "ticks_to_first_announce",
    "ticks_to_first_decide", "messages_per_view_change", "total_sent",
    "total_delivered", "total_dropped", "total_timeouts",
    "total_probes_sent", "total_probes_failed", "invariant_violations",
    "fallback_phase_sent", "view_changes", "max_partitioned_edges",
    "total_link_dropped")
EXACT_DISPATCH_KEYS = ("index", "mode", "pool_id", "pool_shape", "members",
                       "pad_members", "fleet_size", "kinds", "compiled",
                       "padding")


def exact_errors(current: dict, baseline: dict, where: str) -> list:
    """The errors ``bench_compare.compare_run`` reports on ``current``
    against ``baseline`` (its warnings on rates left out)."""
    errors = []
    for key in EXACT_CONFIG_KEYS:
        if current.get(key) != baseline.get(key):
            errors.append(
                f"{where}.{key}: config mismatch (current "
                f"{current.get(key)!r} vs baseline {baseline.get(key)!r}) "
                f"— regenerate the baseline with --update-baseline")
            return errors
    for key in EXACT_RUN_KEYS:
        if key not in current and key not in baseline:
            continue
        if current.get(key) != baseline.get(key):
            errors.append(f"{where}.{key}: {current.get(key)!r} != "
                          f"baseline {baseline.get(key)!r}")
    cur_tel = current.get("telemetry") or {}
    base_tel = baseline.get("telemetry") or {}
    for key in EXACT_TELEMETRY_KEYS:
        if cur_tel.get(key) != base_tel.get(key):
            errors.append(f"{where}.telemetry.{key}: {cur_tel.get(key)!r} "
                          f"!= baseline {base_tel.get(key)!r}")
    if "campaign" in current or "campaign" in baseline:
        cur_c = current.get("campaign") or {}
        base_c = baseline.get("campaign") or {}
        for key in sorted(set(cur_c) | set(base_c)):
            if cur_c.get(key) != base_c.get(key):
                errors.append(f"{where}.campaign.{key}: "
                              f"{cur_c.get(key)!r} != baseline "
                              f"{base_c.get(key)!r}")
    if "dispatch_timeline" in current or "dispatch_timeline" in baseline:
        cur_t = current.get("dispatch_timeline") or []
        base_t = baseline.get("dispatch_timeline") or []
        if len(cur_t) != len(base_t):
            errors.append(
                f"{where}.dispatch_timeline: {len(cur_t)} dispatch "
                f"record(s) != baseline {len(base_t)}")
        for i, (cur_d, base_d) in enumerate(zip(cur_t, base_t)):
            for key in EXACT_DISPATCH_KEYS:
                if cur_d.get(key) != base_d.get(key):
                    errors.append(
                        f"{where}.dispatch_timeline[{i}].{key}: "
                        f"{cur_d.get(key)!r} != baseline "
                        f"{base_d.get(key)!r}")
    return errors


def committed_errors(want, got, path: str = "", skip=()) -> list:
    """Paths where ``got`` differs from ``want`` on the keys ``want`` has
    (recursively, lists element by element), but ``skip``."""
    if path in skip:
        return []
    if isinstance(want, dict):
        if not isinstance(got, dict):
            return [path]
        return [e for k, v in want.items()
                for e in committed_errors(v, got.get(k), f"{path}.{k}",
                                          skip)]
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return [path]
        return [e for i, (a, b) in enumerate(zip(want, got))
                for e in committed_errors(a, b, f"{path}[{i}]", skip)]
    return [] if json.dumps(want) == json.dumps(got) else [path]


def committed(name: str) -> dict:
    """A committed payload of ``benchmarks/``."""
    from pathlib import Path

    return json.loads((Path(__file__).resolve().parent / "benchmarks"
                       / name).read_text())


def campaign_stats(payload: dict) -> dict:
    """The walls of a campaign payload: stage sums, the observatory split,
    throughput, µs per member-tick per pool (dispatch walls and execute
    stages) and the allocator's peak."""
    timeline = payload["dispatch_timeline"]
    stages = {s: sum(r["stages"][s] for r in timeline)
              for s in timeline[0]["stages"]}
    ticks = payload["ticks"]
    pools = {}
    for r in timeline:
        row = pools.setdefault(r["pool_id"], {"mode": r["mode"],
                                              "members": 0, "wall_s": 0.0,
                                              "execute_s": 0.0})
        row["members"] += r["members"]
        row["wall_s"] += r["wall_s"]
        row["execute_s"] += r["stages"]["execute"]
    for row in pools.values():
        member_ticks = row["members"] * ticks
        row["us_per_member_tick"] = row["wall_s"] / member_ticks * 1e6
        row["execute_us_per_member_tick"] = \
            row["execute_s"] / member_ticks * 1e6
    obs = payload["observatory"]
    peaks = [r["memory"]["device_peak_bytes"] for r in timeline]
    return {"wall_s": payload["wall_s"], "stages_s": stages,
            "device_busy_s": obs["device_busy_s"],
            "host_blocked_s": obs["host_blocked_s"],
            "compile_s": obs["compile_s"],
            "clusters_per_sec": payload["clusters_per_sec"],
            "peak_in_flight": obs["pipeline"]["peak_in_flight"],
            "pools": pools, "peak_bytes": max(peaks),
            "compile": obs["compile"]["pools"]}


def print_campaign(phase: int, label: str, stats: dict) -> None:
    stages = ", ".join(f"{k} {v:.3f}" for k, v in stats["stages_s"].items())
    pools = "; ".join(
        f"pool {pid} ({row['mode']}, {row['members']} members) "
        f"{row['us_per_member_tick']:.2f} us/member-tick "
        f"({row['execute_us_per_member_tick']:.2f} executing)"
        for pid, row in stats["pools"].items())
    log(f"phase {phase}: {label}: wall {stats['wall_s']:.3f} s, stage sums "
        f"(s) {stages}; device-busy {stats['device_busy_s']:.3f} s, "
        f"host-blocked {stats['host_blocked_s']:.3f} s, compile "
        f"{stats['compile_s']:.3f} s, {stats['clusters_per_sec']:.2f} "
        f"clusters/s, {stats['peak_in_flight']} dispatches in flight at "
        f"most; {pools}; peak {stats['peak_bytes'] / 2**20:.1f} MiB")


def phase_campaign(rx_account, device) -> tuple:
    """Phase 25, the slice's main path: ``run_campaign`` at
    ``benchmarks/campaign_4096.json``'s configuration on the card, held to
    ``testdata/campaign_4096_reference.json`` in every non-wall field, to
    the committed file's ``campaign`` block on its keys (but
    ``per_receiver.capacity_cap``, raised since it was written) and to
    the golden file on ``bench_compare``'s exact fields; ``rx_deliver``
    launched 6 times a tick of every per-receiver dispatch."""
    from rapid_tpu_torch import campaign, golden
    from rapid_tpu_torch.telemetry import schema

    cfg = campaign.CampaignConfig(**golden.CAMPAIGN_4096)
    zero_counts(rx_account)
    start = time.perf_counter()
    payload = campaign.run_campaign(cfg, device=device)
    seconds = time.perf_counter() - start
    launches = (rx_account.deliver_launches, rx_account.launches)
    if launches != (CAMPAIGN_LAUNCHES, 0):
        raise AssertionError(f"phase 25 launched (rx_deliver, rx_account) "
                             f"{launches}, want {(CAMPAIGN_LAUNCHES, 0)}")
    errors = schema.validate_bench_payload(payload)
    if errors:
        raise AssertionError(f"phase 25 payload fails the schema: "
                             f"{errors[:5]}")
    want = golden.load(golden.CAMPAIGN_PATH)
    got = golden.campaign_record(payload)
    diff_ = golden.differences(got, want)
    if diff_:
        raise AssertionError(f"phase 25 differs from the reference's "
                             f"payload in {diff_[:8]}")
    file_campaign = committed("campaign_4096.json")["campaign"]
    cap = ".per_receiver.capacity_cap"
    diff_ = committed_errors(file_campaign, got["campaign"], skip=(cap,))
    if diff_ or got["campaign"]["per_receiver"]["capacity_cap"] != 4096:
        raise AssertionError(f"phase 25 differs from "
                             f"benchmarks/campaign_4096.json in {diff_[:8]}")
    errors = exact_errors(got, want, "campaign_4096")
    if errors:
        raise AssertionError(f"phase 25 exact fields: {errors[:5]}")
    stats = campaign_stats(payload)
    stats.update(seconds=seconds, deliver_launches=launches[0],
                 account_launches=launches[1])
    log(f"phase 25: run_campaign at campaign_4096.json's configuration "
        f"({payload['clusters']} clusters, N={payload['n']}, "
        f"{payload['ticks']} ticks, {payload['dispatches']} dispatches) "
        f"equals the reference's payload in every non-wall field, the "
        f"committed campaign block on its keys (capacity_cap 4096) and "
        f"bench_compare's exact fields; schema v{payload['schema_version']}"
        f" clean; rx_deliver {launches[0]} launches, rx_account "
        f"{launches[1]}; {seconds:.1f} s in all")
    print_campaign(25, "campaign_4096", stats)
    return payload, stats


def phase_replay(rx_account, device, payload: dict) -> dict:
    """Phase 26: every exemplar of ``benchmarks/campaign_4096.json``
    through ``replay_member`` (verified, its lineage equal to the card
    campaign's exemplar), the one of ``campaign_rx4096.json`` (N=4096,
    packed), and ``--oracle`` on 5:0 and 7:58 with the reference's
    verdicts."""
    from rapid_tpu_torch import replay

    out = {}
    zero_counts(rx_account)
    lineage_by_ref = {
        (ex["dispatch"], ex["member_index"]): ex["lineage"]
        for block in payload["campaign"]["triage"]["classes"].values()
        for ex in block["exemplars"]}
    for name in ("campaign_4096.json", "campaign_rx4096.json"):
        file_payload = committed(name)
        refs = sorted({(ex["dispatch"], ex["member_index"])
                       for block in file_payload["campaign"]["triage"]
                       ["classes"].values()
                       for ex in block["exemplars"]
                       if ex["expected"] is not None})
        for d, j in refs:
            start = time.perf_counter()
            rec = replay.replay_member(file_payload, d, j, lineage=True,
                                       device=device)
            seconds = time.perf_counter() - start
            recorder_ok = (rec["recorder_match"] is True
                           or file_payload["campaign"]["flight_recorder"]
                           == 0)
            lineage_ok = (name != "campaign_4096.json"
                          or rec["lineage"] == lineage_by_ref[(d, j)])
            if rec["match"] is not True or not recorder_ok \
                    or not lineage_ok:
                raise AssertionError(
                    f"phase 26: {name} {d}:{j} replays with match "
                    f"{rec['match']}, recorder_match "
                    f"{rec['recorder_match']}, lineage "
                    f"{'equal' if lineage_ok else 'different'}: "
                    f"{rec['mismatches']}")
            out[f"{name}:{d}:{j}"] = {"kind": rec["kind"],
                                      "mode": rec["mode"],
                                      "seconds": seconds}
            log(f"phase 26: {name} exemplar {d}:{j} ({rec['kind']}, "
                f"{rec['mode']}) replays verified: match True, "
                f"recorder_match {rec['recorder_match']}"
                + (", lineage equal to phase 25's"
                   if name == "campaign_4096.json" else "")
                + f"; {seconds:.2f} s")
    file_payload = committed("campaign_4096.json")
    for ref, verdict in REPLAY_ORACLE_VERDICTS.items():
        d, j = map(int, ref.split(":"))
        start = time.perf_counter()
        rec = replay.replay_member(file_payload, d, j, oracle=True,
                                   device=device)
        seconds = time.perf_counter() - start
        if rec["oracle"]["run"] is not True \
                or rec["oracle"]["passed"] is not verdict:
            raise AssertionError(f"phase 26: --oracle on {ref} gave "
                                 f"{rec['oracle']}, the reference "
                                 f"{verdict}")
        out[f"oracle:{ref}"] = {"passed": verdict, "seconds": seconds}
        log(f"phase 26: --oracle on {ref} ({rec['kind']}, {rec['mode']}): "
            f"passed {verdict}, as the reference's; {seconds:.2f} s")
    out["deliver_launches"] = rx_account.deliver_launches
    out["account_launches"] = rx_account.launches
    return out


def phase_committed(rx_account, device) -> dict:
    """Phase 27: a campaign at ``baseline.json``'s ``fleet`` configuration
    against that entry's exact fields, and ``run_tournament(["rapid",
    "ring"])`` at ``campaign_tournament.json``'s against its whole
    ``campaign`` block and exact fields."""
    from rapid_tpu_torch import campaign
    from rapid_tpu_torch.faults import ScenarioWeights

    out = {}
    want = committed("baseline.json")["fleet"]
    zero_counts(rx_account)
    cfg = campaign.CampaignConfig(clusters=128, n=64, ticks=120, seed=0,
                                  fleet_size=64)
    payload = campaign.run_campaign(cfg, device=device)
    errors = exact_errors(json.loads(json.dumps(payload)), want, "fleet")
    if errors:
        raise AssertionError(f"phase 27 fleet: {errors[:5]}")
    out["fleet"] = campaign_stats(payload)
    out["fleet"]["deliver_launches"] = rx_account.deliver_launches
    log(f"phase 27: baseline.json's fleet entry reproduced on every exact "
        f"field ({payload['dispatches']} dispatches, "
        f"{rx_account.deliver_launches} rx_deliver launches)")
    print_campaign(27, "fleet", out["fleet"])
    want = committed("campaign_tournament.json")
    camp = want["campaign"]
    cfg = campaign.CampaignConfig(
        clusters=camp["clusters"], n=camp["n"], ticks=camp["ticks"],
        seed=camp["seed"], fleet_size=camp["fleet_size"],
        headroom=camp["headroom"], weights=ScenarioWeights(**camp["weights"]))
    zero_counts(rx_account)
    start = time.perf_counter()
    payload = campaign.run_tournament(cfg, ["rapid", "ring"], device=device)
    seconds = time.perf_counter() - start
    got = json.loads(json.dumps(payload))
    errors = exact_errors(got, want, "tournament")
    if got["campaign"] != camp or errors:
        raise AssertionError(
            f"phase 27 tournament differs from campaign_tournament.json: "
            f"{committed_errors(camp, got['campaign'])[:8]} {errors[:5]}")
    out["tournament"] = campaign_stats(payload)
    out["tournament"].update(seconds=seconds,
                             deliver_launches=rx_account.deliver_launches)
    log(f"phase 27: run_tournament(rapid, ring) equals "
        f"campaign_tournament.json's campaign block and exact fields; "
        f"{seconds:.1f} s for both variants, "
        f"{rx_account.deliver_launches} rx_deliver launches")
    print_campaign(27, "tournament (rapid)", out["tournament"])
    return out


# --- the streaming service (phases 28-32) ---------------------------------

#: Phase 29's depth: chunks of the soak, and the chunk of its round trip
#: (``benchmarks/soak.json`` runs 200 with the round trip at 100; the
#: whole soak runs through ``python -m rapid_tpu_torch.service --soak``).
SOAK_CHUNKS = 24
SOAK_VERIFY_AT = 12

#: Phase 30: ``benchmarks/rx_soak.json``'s configuration.
RX_SOAK = {"n": 1024, "chunk": 16, "chunks": 12, "verify_at": 6,
           "horizon": 192, "recorder": 8, "slo_window": 8, "seed": 0}
RX_SOAK_LAUNCHES = 6 * 16 * (12 + 1)   # the round trip runs two chunks

#: The reference's messages of the three checkpoint refusals (phase 28).
CHECKPOINT_REFUSALS = {
    "version": ("CheckpointVersionError",
                "checkpoint was saved as version 99 but this build reads "
                "version 1; re-save with a matching build (no cross-version "
                "migration is defined)"),
    "statics": ("CheckpointCompatError",
                "checkpoint statics do not match the restoring Settings "
                "(rx_kernel: saved='packed' expected='pallas'); restore "
                "with the Settings the run was saved under"),
    "leaves": ("CheckpointError",
               "checkpoint leaf table does not match arrays.npz (missing "
               "from npz: [], undeclared: ['recorder.ring'])"),
}


def stream_stats(stream, ticks_run: int) -> dict:
    """Timing of a resident run: wall ms per tick and ticks/s over the
    ticks it ran (a round trip runs two chunks), the first dispatch's
    one-time work, and per chunk summed: the host's dispatch seconds (the
    tick loop enqueues the chunk's kernels and reads the card on every
    branch), its wait on the chunk's fence, and the CUDA-event span of
    the chunk's device work."""
    t = stream.timing
    wall = sum(r["wall_s"] for r in stream.chunk_records)
    return {"ticks_run": ticks_run, "wall_s": wall,
            "ms_per_tick": wall * 1e3 / ticks_run,
            "ticks_per_sec": ticks_run / wall,
            "compile_s": stream.compile_s,
            "dispatch_s": sum(r["dispatch_s"] for r in t),
            "fence_s": sum(r["fence_s"] for r in t),
            "device_span_s": sum(r["device_s"] for r in t)}


def busy_window(run, ticks: int, label: str) -> dict:
    """``profile.profile_window`` of ``run`` (``ticks`` ticks): the card's
    busy share of a chunk's wall."""
    from rapid_tpu_torch import profile

    w = profile.profile_window(run, ticks, 5, {"window": label})
    w["busy_share"] = (w["device_busy_ms_per_tick"]
                       / w["wall_ms_per_tick"])
    return w


def print_stream(phase: int, label: str, st: dict, w: dict) -> None:
    busy = st["wall_s"] * w["busy_share"]
    log(f"phase {phase}: {label}: {st['ms_per_tick']:.4f} ms/tick, "
        f"{st['ticks_per_sec']:.1f} ticks/s over {st['ticks_run']} ticks "
        f"({st['wall_s']:.3f} s); host dispatch {st['dispatch_s']:.3f} s, "
        f"fence waits {st['fence_s']:.3f} s, device spans "
        f"{st['device_span_s']:.3f} s; one-time work "
        f"{st['compile_s']:.4f} s; under torch.profiler "
        f"{w['wall_ms_per_tick']:.4f} ms/tick wall, "
        f"{w['device_busy_ms_per_tick']:.4f} device-busy "
        f"({100 * w['busy_share']:.1f} %), "
        f"{w['device_kernels_per_tick']:.1f} kernels/tick: device-busy "
        f"about {busy:.2f} s, host-blocked about {st['wall_s'] - busy:.2f} "
        f"s of the wall")


def phase_checkpoints(rx_account, device) -> dict:
    """Phase 28: each committed reference checkpoint restored on the
    card, continued one chunk, saved, loaded and continued again, equal
    to ``continuations.json``; the manifests validate; a version, statics
    or leaf-table mismatch raises the reference's error."""
    import shutil
    import tempfile
    from pathlib import Path

    from rapid_tpu_torch import golden
    from rapid_tpu_torch.service import checkpoint
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.telemetry import schema

    svc = golden.PortService(device)
    want = golden.load(golden.CHECKPOINT_PATH)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for family in golden.CHECKPOINT_FAMILIES:
            zero_counts(rx_account)
            start = time.perf_counter()
            got = golden.continue_checkpoint(svc, family,
                                             golden.CHECKPOINT_DIR / family,
                                             Path(tmp) / family)
            seconds = time.perf_counter() - start
            diffs = golden.differences(got, want[family])
            if diffs:
                raise AssertionError(f"phase 28 {family}: {diffs[:8]}")
            errors = []
            for where in (golden.CHECKPOINT_DIR / family, Path(tmp) / family):
                manifest = json.loads((where / "manifest.json").read_text())
                errors += schema.validate_checkpoint_manifest(manifest)
            launches = (rx_account.deliver_launches, rx_account.launches)
            ticks = 2 * (golden.SOAK["chunk"] if family == "engine"
                         else golden.RX_CHECKPOINT["chunk"])
            expect = (0 if family == "engine" else 6 * ticks, 0)
            if errors or launches != expect:
                raise AssertionError(f"phase 28 {family}: {errors[:4]}, "
                                     f"launches {launches} want {expect}")
            out[family] = {"seconds": seconds, "ticks": ticks,
                           "deliver_launches": launches[0],
                           "decides": [c["decides"]
                                       for c in got["continuations"]]}
            log(f"phase 28: the reference's {family} checkpoint (tick "
                f"{got['tick']}) restored on the card and continued "
                f"{ticks} ticks across a save and load: equal to the "
                f"reference's run (logs, final state, recorder"
                f"{', traffic' if family == 'engine' else ''}); decides "
                f"{out[family]['decides']}; {seconds:.2f} s; "
                f"{launches[0]} rx_deliver launches; manifests valid")
        src = golden.CHECKPOINT_DIR / "receiver_packed"
        packed = Settings(rx_kernel="packed", flight_recorder_window=8)
        for how, (error, message) in CHECKPOINT_REFUSALS.items():
            path = Path(tmp) / f"bad_{how}"
            shutil.copytree(src, path)
            manifest = json.loads((path / "manifest.json").read_text())
            settings = packed
            if how == "version":
                manifest["checkpoint_version"] = 99
            elif how == "statics":
                settings = packed.with_(rx_kernel="pallas")
            else:
                manifest["leaves"] = [leaf for leaf in manifest["leaves"]
                                      if leaf["name"] != "recorder.ring"]
            (path / "manifest.json").write_text(json.dumps(manifest))
            try:
                checkpoint.load_checkpoint(str(path), settings,
                                           device=device)
            except checkpoint.CheckpointError as exc:
                if type(exc).__name__ != error or str(exc) != message:
                    raise AssertionError(f"phase 28 {how}: {exc!r}")
            else:
                raise AssertionError(f"phase 28 {how}: no error")
        log(f"phase 28: a version, statics and leaf-table mismatch raise "
            f"{', '.join(e for e, _ in CHECKPOINT_REFUSALS.values())} with "
            f"the reference's messages")
    return out


def phase_soak(rx_account, device) -> dict:
    """Phase 29: the soak at ``soak.json``'s configuration for
    ``SOAK_CHUNKS`` chunks with its round trip at ``SOAK_VERIFY_AT``,
    every chunk record equal to the file's; the stream validates and the
    watermark gate holds."""
    import tempfile
    from pathlib import Path

    import torch

    from rapid_tpu_torch import golden
    from rapid_tpu_torch.engine.step import simulate_chunk
    from rapid_tpu_torch.telemetry import schema

    svc = golden.PortService(device)
    zero_counts(rx_account)
    with tempfile.TemporaryDirectory() as tmp:
        sink = Path(tmp) / "soak.jsonl"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = golden.boot_soak(svc, sink=str(sink))
        golden.run_stream(eng, SOAK_CHUNKS, SOAK_VERIFY_AT, Path(tmp) / "ck")
        summary = eng.summary()
        eng.close()
        lines = sink.read_text().splitlines()
    errors = (golden.soak_errors(eng.chunk_records)
              + schema.validate_streaming_stream(lines))
    marks = summary["live_buffer_bytes"]
    block = eng.chunk_records[SOAK_VERIFY_AT]["checkpoint"]
    if errors or marks["steady_max"] > 1.10 * marks["first"] or \
            not all(v for k, v in block.items() if k.endswith("identical")):
        raise AssertionError(f"phase 29: {errors[:6]} {marks} {block}")
    if (rx_account.deliver_launches, rx_account.launches) != (0, 0):
        raise AssertionError("phase 29 launched a delivery kernel")
    chunk = golden.SOAK["chunk"]
    st = stream_stats(eng, (SOAK_CHUNKS + 1) * chunk)
    st.update(peak_mib=torch.cuda.max_memory_allocated() / 2**20,
              watermark=marks, events=summary["events_injected"],
              decisions=summary["decisions"])
    inert = eng._inert_schedule
    w = busy_window(lambda: simulate_chunk(
        eng.state, eng._faults, 64, eng.settings, churn=inert,
        device=device)[1].decide_now, 64, "soak")
    st["window"] = w
    log(f"phase 29: the soak (N=24 in 96 slots, chunks of {chunk}), "
        f"{SOAK_CHUNKS} chunks with the round trip at chunk "
        f"{SOAK_VERIFY_AT} (tick {block['tick']}, all identical): every "
        f"chunk record equals soak.json's ({summary['events_injected']} "
        f"events, {summary['decisions']} decisions); stream valid; "
        f"watermark {marks} (steady_max <= 1.10 first); peak "
        f"{st['peak_mib']:.1f} MiB")
    print_stream(29, "soak", st, w)
    return st


def phase_rx_soak(rx_account, device) -> dict:
    """Phase 30: the per-receiver soak at ``rx_soak.json``'s
    configuration under "packed", every record equal to the file's, 1,248
    ``rx_deliver`` launches; then under ``Settings()`` (the dense carry),
    every record equal to the packed run's, the same launches."""
    import tempfile
    from pathlib import Path

    import torch

    from rapid_tpu_torch import golden
    from rapid_tpu_torch.engine.receiver import receiver_simulate_chunk
    from rapid_tpu_torch.service import boot_resident_receiver
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.telemetry.slo import SloWindows

    want = committed("rx_soak.json")
    c = RX_SOAK
    out, first = {}, None
    strip = lambda r: {k: v for k, v in r.items()
                       if k not in golden.STREAM_WALL_KEYS}
    for layout in ("packed", "xla"):
        settings = Settings(rx_kernel=layout,
                            flight_recorder_window=c["recorder"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts(rx_account)
        rx = boot_resident_receiver(
            settings, c["n"], seed=c["seed"], horizon_ticks=c["horizon"],
            chunk_ticks=c["chunk"], slo=SloWindows(c["slo_window"]),
            device=device)
        with tempfile.TemporaryDirectory() as tmp:
            golden.run_stream(rx, c["chunks"], c["verify_at"],
                              Path(tmp) / "ck")
        summary = rx.summary()
        launches = (rx_account.deliver_launches, rx_account.launches)
        records = [strip(r) for r in rx.chunk_records]
        errors = []
        for got, ref in zip(records, want["chunks"]):
            errors += [f"chunk {ref['index']}: {k}" for k in ref
                       if k not in golden.SOAK_SKIP_KEYS
                       and got.get(k) != ref[k]]
        errors += [f"summary: {k}" for k in want["summary"]
                   if k not in golden.SOAK_SKIP_KEYS + ("schema_version",)
                   and summary.get(k) != want["summary"][k]]
        if summary["checkpoint"] != want["summary"]["checkpoint"]:
            errors.append(f"checkpoint {summary['checkpoint']}")
        if first is not None and records != first:
            errors.append("records differ from the packed run's")
        if errors or launches != (RX_SOAK_LAUNCHES, 0):
            raise AssertionError(f"phase 30 {layout}: {errors[:8]}, "
                                 f"launches {launches}")
        first = first or records
        st = stream_stats(rx, RX_SOAK_LAUNCHES // 6)
        st.update(peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                  run_peak_mib=(torch.cuda.max_memory_allocated() - base)
                  / 2**20, deliver_launches=launches[0],
                  decisions=summary["decisions"],
                  watermark=summary["live_buffer_bytes"])
        log(f"phase 30: rx_soak.json's per-receiver soak (N={c['n']}, "
            f"{c['chunks']} chunks of {c['chunk']}, round trip at tick "
            f"{summary['checkpoint']['tick']}) under rx_kernel={layout!r}: "
            f"every record equals the file's ({summary['decisions']} "
            f"decisions); {launches[0]} rx_deliver launches, 0 rx_account;"
            f" peak {st['peak_mib']:.1f} MiB ({st['run_peak_mib']:.1f} "
            f"above the run's start); watermark {st['watermark']}")
        zero_counts(rx_account)
        carry, faults = rx.carry, rx._faults
        w = busy_window(lambda: receiver_simulate_chunk(
            carry, faults, 4, settings)[1].decide, 4, f"rx_soak {layout}")
        zero_counts(rx_account)
        st["window"] = w
        print_stream(30, f"rx_soak {layout}", st, w)
        out[layout] = st
        del rx, carry, faults
    return out


def phase_stream_n100k(rx_account, device, phase7: dict) -> dict:
    """Phase 31: a resident shared engine at N=100,000 (phase 9's 100,096
    slots), the soak's traffic, 6 chunks of 256 with the round trip at
    chunk 3, equal to ``stream_n100k.json``: every record, the summary
    and a SHA-256 of every final-state field."""
    import tempfile

    import torch

    from rapid_tpu_torch import golden

    svc = golden.PortService(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts(rx_account)
    keep = {}
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        got = golden.n100k_stream_record(svc, tmp, keep)
    seconds = time.perf_counter() - start
    diffs = golden.differences(got, golden.load(golden.STREAM_N100K_PATH))
    if diffs or rx_account.deliver_launches:
        raise AssertionError(f"phase 31: {diffs[:8]}")
    eng = keep["engine"]
    cfg = golden.STREAM_N100K
    st = stream_stats(eng, (cfg["chunks"] + 1) * cfg["chunk"])
    st.update(seconds=seconds,
              peak_mib=torch.cuda.max_memory_allocated() / 2**20,
              run_peak_mib=(torch.cuda.max_memory_allocated() - base)
              / 2**20, decisions=got["summary"]["decisions"],
              watermark=eng._watermark_block())
    log(f"phase 31: the resident shared engine at N=100,000 (100,096 "
        f"slots), 6 chunks of 256 with the round trip at chunk 3: every "
        f"record, the summary and every final-state field's SHA-256 equal "
        f"stream_n100k.json ({st['decisions']} decisions); {seconds:.1f} s "
        f"with the boot; peak {st['peak_mib']:.1f} MiB "
        f"({st['run_peak_mib']:.1f} above the start) beside phase 7's "
        f"{phase7['ms_per_tick']:.4f} ms/tick and "
        f"{phase7['peak_bytes'] / 2**20:.1f} MiB")
    from rapid_tpu_torch.engine.step import simulate_chunk

    w = busy_window(lambda: simulate_chunk(
        eng.state, eng._faults, 16, eng.settings, churn=eng._inert_schedule,
        device=device)[1].decide_now, 16, "n100k")
    st["window"] = w
    print_stream(31, "N=100,000 resident", st, w)
    return st


def phase_servo_status(rx_account, device) -> dict:
    """Phase 32: the pinned servo stream (``--target-rate 40
    --pinned-tps 1000`` at the soak's configuration, 8 chunks) with a
    status file and socket attached: every record equals
    ``stream_servo.json``; a snapshot a chunk, each valid; ``read_status``
    answers over the socket and ``watch`` streams every later frame."""
    import socket
    import tempfile
    import threading
    from pathlib import Path

    from rapid_tpu_torch import golden
    from rapid_tpu_torch.service import StatusPublisher, read_status
    from rapid_tpu_torch.telemetry import schema

    svc = golden.PortService(device)
    cfg = golden.SERVO_STREAM
    zero_counts(rx_account)
    with tempfile.TemporaryDirectory() as tmp:
        sock = str(Path(tmp) / "status.sock")
        status = StatusPublisher(file_path=str(Path(tmp) / "status.json"),
                                 socket_path=sock)
        frames, ready = [], threading.Event()

        def watch():
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sk:
                sk.settimeout(120)
                sk.connect(sock)
                sk.sendall(b"watch\n")
                ready.set()
                with sk.makefile("r") as fh:
                    for line in fh:
                        frames.append(json.loads(line))
                        if len(frames) == cfg["chunks"]:
                            return

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        ready.wait(30)
        time.sleep(0.2)
        servo = svc.service.LoadServo(svc.service.ServoConfig(
            target_events_per_sec=cfg["target_rate"],
            pinned_ticks_per_sec=cfg["pinned_tps"]))
        eng = golden.boot_soak(svc, cfg, servo=servo, status=status,
                               closed_loop=True)
        golden.run_stream(eng, cfg["chunks"], cfg["verify_at"],
                          Path(tmp) / "ck")
        watcher.join(60)
        snap = read_status(sock)[0]
        on_file = json.loads((Path(tmp) / "status.json").read_text())
        got = golden.stream_record(eng)
        eng.close()
    diffs = golden.differences(got, golden.load(golden.SERVO_PATH))
    errors = [e for f in frames + [snap, on_file]
              for e in schema.validate_status_snapshot(f)]
    ticks = [f["tick"] for f in frames]
    want_ticks = [golden.SOAK["chunk"] * (i + 1)
                  for i in range(cfg["chunks"])]
    if diffs or errors or ticks != want_ticks or \
            snap["tick"] != on_file["tick"] != want_ticks[-1]:
        raise AssertionError(f"phase 32: {diffs[:6]} {errors[:4]} {ticks}")
    rates = sorted({c["servo"]["rate_per_ktick"] for c in got["chunks"]})
    log(f"phase 32: the pinned servo stream ({cfg['chunks']} chunks, rate "
        f"{rates} events/ktick, {got['summary']['events_injected']} "
        f"events) equals stream_servo.json, servo blocks included; "
        f"{len(frames)} status frames over watch at ticks {ticks}, each "
        f"valid, read_status and the file at tick {snap['tick']}")
    return {"frames": len(frames), "events": got["summary"]["events_injected"],
            "rates": rates}


def planned_child() -> dict:
    """Phase 15 in a child process under ``PYTHONHASHSEED`` of the golden
    files; any failure there fails this process."""
    import os

    from rapid_tpu_torch import golden

    env = dict(os.environ, PYTHONHASHSEED=golden.PLAN_HASH_SEED)
    done = subprocess.run([sys.executable, __file__, "--planned"], env=env,
                          capture_output=True, text=True, timeout=900)
    for line in done.stdout.splitlines()[:-1]:
        log(line)
    if done.returncode != 0:
        print(done.stderr[-6000:], file=sys.stderr)
        raise AssertionError(f"phase 15's child exited {done.returncode}")
    return json.loads(done.stdout.splitlines()[-1])


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from rapid_tpu_torch.engine import rx_account
        from rapid_tpu_torch.settings import Settings
    except ImportError as exc:
        print(f"chip_smoke: rapid_tpu_torch not found beside the script "
              f"({exc})", file=sys.stderr)
        return 2
    loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m == "rapid_tpu" or m.startswith("rapid_tpu.")]
    if loaded:
        print(f"chip_smoke: JAX modules loaded: {loaded}", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--planned"]:
        print(json.dumps(phase_planned(torch.device("cuda", 0), rx_account)))
        return 0

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave no output"
    log(f"phase 1: {card}")
    device = torch.device("cuda", 0)
    settings = Settings(rx_kernel="pallas")

    phase_build(rx_account)
    err_deliver = phase_parity_deliver(rx_account, device)
    err_account = phase_parity(rx_account, device)
    keep = {}
    phase_golden(settings, device)
    main_run = phase_main(rx_account, settings, device, keep)
    wide = phase_wide(rx_account, settings, device)
    times = kernel_times(rx_account, device)
    shared = {"n1000": phase_shared("shared_n1000_crash", 6, device,
                                    rx_account)}
    shared["n100k_crash"] = phase_shared("shared_n100k_crash", 7, device,
                                         rx_account, keep)
    if shared["n100k_crash"]["decides"] != [(113, 1000)] or \
            shared["n100k_crash"]["n_member"] != 99_000:
        raise AssertionError("the N=100,000 burst did not decide at tick "
                             "113 leaving 99,000 members")
    shared["n100k_drop_flipflop"] = phase_shared(
        "shared_n100k_drop_flipflop", 8, device, rx_account)
    churn = shared["n100k_churn"] = phase_shared(
        "shared_n100k_churn", 9, device, rx_account, keep)
    if len(churn["decides"]) != 24 or churn["n_member"] != 100_000:
        raise AssertionError("the churn run did not decide 24 bursts "
                             "leaving 100,000 members")
    contested = shared["n100k_contested"] = phase_shared(
        "shared_n100k_contested", 10, device, rx_account, keep)
    if len(contested["classic_decides"]) != 8 or \
            len(contested["decides"]) != 8 or \
            contested["classic_decides"][0] != 19 or \
            contested["n_member"] != 99_992:
        raise AssertionError("the contested run did not decide 8 classic "
                             "rounds from tick 19 leaving 99,992 members")
    for phase, variant in ((11, "ring"), (12, "hier")):
        run = shared[f"n100k_crash_{variant}"] = phase_shared(
            f"shared_n100k_crash_{variant}", phase, device, rx_account)
        if run["decides"] != [(113, 1000)] or run["n_member"] != 99_000:
            raise AssertionError(f"the {variant} variant did not decide the "
                                 f"burst at tick 113")
        print_factors(phase, variant, run, shared["n100k_crash"])
    shared["monitor"] = phase_monitor(device, rx_account)
    shared["recorder"] = phase_recorder(device, rx_account, keep)
    planned = shared["planned"] = planned_child()
    want = {"shared_n100k_planned_churn": ([[16, 16], [29, 16], [46, 16],
                                            [59, 16]], 100_000),
            "shared_n10k_planned_mixed": ([[113, 500], [126, 16], [139, 16],
                                           [156, 16], [169, 16]], 9_500)}
    for name, (decides, members) in want.items():
        if planned[name]["decides"] != decides or \
                planned[name]["n_member"] != members:
            raise AssertionError(f"{name} decided {planned[name]['decides']}"
                                 f" leaving {planned[name]['n_member']}")
    for run in shared.values():
        run.pop("log", None)
    err_fleet, fleet_times = phase_fleet_deliver(rx_account, device)
    fleet_pools, pool_outputs = phase_fleet_pools(device)
    scaling = phase_fleet_scaling(device, pool_outputs)
    for pool_id in (1, 3):
        del pool_outputs[pool_id]
    layouts = phase_layouts(rx_account, device, keep, main_run)
    wide_dense = phase_wide_dense(rx_account, device)
    dense_fleets = phase_dense_fleets(device, fleet_pools)
    telemetry = phase_telemetry(keep, pool_outputs)
    del pool_outputs
    referee_rx = phase_referee_receiver(rx_account, device, keep)
    del keep
    referee_shared = phase_referee_shared(rx_account, device)
    campaign_payload, campaign_run = phase_campaign(rx_account, device)
    replays = phase_replay(rx_account, device, campaign_payload)
    del campaign_payload
    committed_runs = phase_committed(rx_account, device)
    stream = {"checkpoints": phase_checkpoints(rx_account, device),
              "soak": phase_soak(rx_account, device),
              "rx_soak": phase_rx_soak(rx_account, device),
              "n100k": phase_stream_n100k(rx_account, device,
                                          shared["n100k_crash"]),
              "servo_status": phase_servo_status(rx_account, device)}

    main_t, wide_t = times[MAIN_N], times[WIDE_N]
    kernels = [{
        "name": "rx_deliver",
        "route": "cuda",
        "source": "rapid_tpu_torch/engine/csrc/rx_deliver.cu",
        "replaces": "rapid_tpu/engine/rx_pallas.py:61",
        "with_wrapper": "rapid_tpu/engine/rx_pallas.py:72",
        "on_main_path": True,
        "launches": main_run["deliver_launches"],
        "max_abs_err": max(err_deliver, err_fleet),
        "parity": "exact",
        **main_t["rx_deliver"],
        "bound_by": "bytes",
        "library_ms": None,
        "c4096": wide_t["rx_deliver"],
        "composed": {"c1024": main_t["composed"],
                     "c4096": wide_t["composed"]},
        "fleet_launches": {f"pool{pid}": run["deliver_launches"]
                           for pid, run in fleet_pools.items()},
        "launches_by_layout": {k: v["deliver_launches"]
                               for k, v in layouts.items()},
        "dense_fleet_launches": {f"pool{pid}": run["deliver_launches"]
                                 for pid, run in dense_fleets.items()},
        "referee_launches": {k: v["deliver_launches"]
                             for k, v in referee_rx.items()},
        "campaign_launches": campaign_run["deliver_launches"],
        "replay_launches": replays["deliver_launches"],
        "committed_launches": {k: v["deliver_launches"]
                               for k, v in committed_runs.items()},
        "stream_launches": {k: v["deliver_launches"]
                            for k, v in stream["rx_soak"].items()},
        "checkpoint_launches": {
            k: v["deliver_launches"]
            for k, v in stream["checkpoints"].items()},
        "fleet_max_abs_err": err_fleet,
        "fleet_f256": {f"c{c}": t for c, t in fleet_times.items()},
    }, {
        "name": "rx_account",
        "route": "cuda",
        "source": "rapid_tpu_torch/engine/csrc/rx_account.cu",
        "replaces": "rapid_tpu/engine/rx_pallas.py:61",
        "on_main_path": False,
        "launches": main_run["account_launches"],
        "max_abs_err": err_account,
        "parity": "exact",
        **main_t["rx_account"],
        "bound_by": "bytes",
        "library_ms": None,
        "c4096": wide_t["rx_account"],
    }]
    log(json.dumps({"main_path": main_run,
                    "wide": {"n": WIDE_N, "ticks": WIDE_TICKS, **wide},
                    "shared": shared, "fleet_pools": fleet_pools,
                    "fleet_scaling": scaling,
                    "fleet_deliver": fleet_times, "layouts": layouts,
                    "wide_dense": wide_dense, "dense_fleets": dense_fleets,
                    "telemetry": telemetry, "referee_receiver": referee_rx,
                    "referee_shared": referee_shared,
                    "campaign": campaign_run, "replay": replays,
                    "committed": committed_runs, "stream": stream,
                    "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
