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
   card (a warm-up run each, then two rounds of default, composed,
   composed, default; every run equal to the first and launching only
   its own kernel), ms per tick each; the host's µs per delivery call
   inside a tick for each path; and kernels per tick of each path over
   ticks 106-120 under ``torch.profiler``;
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
    totals.

Between phases 5 and 6 the kernels are timed at C=1024 and 4096: device
time per launch (CUDA graph replay), time per eager wrapper call, the
plain version's time and the byte bound, for ``rx_deliver``, for the
whole ``account`` on the same inputs and for ``rx_account`` alone.
Phases 6-10 print ms per tick (CUDA events around ``simulate``), host
reads per tick, peak allocated memory, the decides and the setup seconds
(the schedule and ``init_state``), and count both kernels' launches in
each (none: the shared engine has no kernel).

The line before the last is the ``kernels`` JSON line; the last line is
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
TURN_ROUNDS = 2                # rounds of default, composed, composed, default
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
L2_BYTES = 50 * 2**20          # H100 L2 cache


def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_main(rx_account, settings, device) -> dict:
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
                               TURN_ROUNDS, check)
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
    windows = tick_time.windows(member, settings, tick_time.PATHS)
    for name, w in windows.items():
        log(f"phase 4: {name} path, ticks {w['from_tick'] + 1}-"
            f"{w['from_tick'] + w['ticks']} under torch.profiler: "
            f"{w['device_kernels_per_tick']:.1f} kernels/tick, "
            f"{w['aten_ops_per_tick']:.1f} aten ops/tick, "
            f"{w['wall_ms_per_tick']:.2f} ms/tick wall, "
            f"{w['device_busy_ms_per_tick']:.3f} ms/tick device-busy")
    zero_counts(rx_account)
    return {"n": n, "ticks": ticks, "deliver_launches": fused,
            "account_launches": packed,
            "ms_per_tick": ms_tick, "decided": decided, "in_turns": turns,
            "delivery_calls": calls, "profile": windows}


def phase_wide(rx_account, settings, device) -> dict:
    import torch
    from rapid_tpu_torch.engine import receiver
    from rapid_tpu_torch.faults import AdversarySchedule, LinkWindow

    n = WIDE_N
    cut = n // 8
    schedule = AdversarySchedule(
        n=n, windows=(LinkWindow(src_slots=frozenset(range(cut)),
                                 dst_slots=frozenset(range(cut, n)),
                                 start_tick=3),), seed=1)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rx_account)
    _, final, logs, ms_tick = run(schedule, settings, WIDE_TICKS, device)
    peak = torch.cuda.max_memory_allocated()
    counts = (rx_account.deliver_launches, rx_account.launches)
    if counts != (6 * WIDE_TICKS, 0):
        raise AssertionError(f"N={n} launched (rx_deliver, rx_account) "
                             f"{counts}, want {(6 * WIDE_TICKS, 0)}")
    receiver.check_flags(final.flags)
    edges = logs.partitioned_edges.cpu().numpy()
    want = np.array([cut * (n - cut) if t >= 3 else 0
                     for t in range(1, WIDE_TICKS + 1)])
    if not np.array_equal(edges, want):
        raise AssertionError(f"partitioned edges {edges} != {want}")
    if len(set(receiver.receiver_config_ids(final))) != 1:
        raise AssertionError("config ids diverged without a decide")
    log(f"phase 5: N={n} x {WIDE_TICKS} ticks: {ms_tick:.1f} ms/tick, "
        f"peak {peak / 2**30:.2f} GiB, {counts[0]} rx_deliver launches")
    return {"ms_per_tick": ms_tick, "peak_bytes": peak,
            "deliver_launches": counts[0]}


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


def phase_shared(name: str, phase: int, device, rx_account) -> dict:
    """One golden scenario through the shared engine's entry points, with
    both kernels' launch counts zeroed just before the run and read after
    (the shared engine has no kernel: any launch fails the phase)."""
    import torch
    from rapid_tpu_torch import device as device_mod
    from rapid_tpu_torch import golden
    from rapid_tpu_torch.engine import diff, simulate
    from rapid_tpu_torch.settings import Settings

    sc = golden.SHARED[name]
    boot = sc.boot(device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reads = device_mod.host_reads
    zero_counts(rx_account)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    final, logs = simulate(boot.state, boot.faults, golden.SHARED_TICKS,
                           Settings(), churn=boot.churn,
                           fallback=boot.fallback)
    end.record()
    end.synchronize()
    launches = rx_account.deliver_launches + rx_account.launches
    ms_tick = start.elapsed_time(end) / golden.SHARED_TICKS
    reads = (device_mod.host_reads - reads) / golden.SHARED_TICKS
    peak = torch.cuda.max_memory_allocated()
    if launches:
        raise AssertionError(f"{name} launched a delivery kernel "
                             f"{launches} times")
    rec = golden.shared_run_record(name, final, logs)
    diff_ = golden.differences(rec, golden.load(sc.path))
    if diff_:
        raise AssertionError(f"{name} differs from its golden file in "
                             f"{diff_[:8]}")
    phases = diff.expand_fallback_counters(logs)
    decides = [(e["tick"], len(e["slots"])) for e in rec["events"]
               if e["kind"] == "view_change"]
    # A classic decide lands with the phase-2b messages.
    classic = [t for t, _ in decides if phases[t - 1]["phase2b_delivered"]]
    totals = {key: sum(row[key] for row in phases) for key in phases[0]
              if key.endswith("_sent")}
    log(f"phase {phase}: {name} x {golden.SHARED_TICKS} ticks equals its "
        f"golden file: {ms_tick:.3f} ms/tick, {reads:.3f} host reads/tick, "
        f"peak {peak / 2**20:.1f} MiB, setup {boot.setup_s:.2f} s, "
        f"decides {decides}, {len(classic)} by the classic round, "
        f"{rec['log']['n_member'][-1]} members at the end, "
        f"{launches} launches of rx_deliver and rx_account")
    if boot.fallback is not None:
        log(f"phase {phase}: consensus messages sent by phase {totals}")
    return {"n": sc.n, "ticks": golden.SHARED_TICKS, "ms_per_tick": ms_tick,
            "host_reads_per_tick": reads, "peak_bytes": peak,
            "setup_s": boot.setup_s, "decides": decides,
            "classic_decides": classic, "phase_sent": totals,
            "n_member": rec["log"]["n_member"][-1],
            "kernel_launches": launches}


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
    phase_golden(settings, device)
    main_run = phase_main(rx_account, settings, device)
    wide = phase_wide(rx_account, settings, device)
    times = kernel_times(rx_account, device)
    shared = {"n1000": phase_shared("shared_n1000_crash", 6, device,
                                    rx_account)}
    shared["n100k_crash"] = phase_shared("shared_n100k_crash", 7, device,
                                         rx_account)
    if shared["n100k_crash"]["decides"] != [(113, 1000)] or \
            shared["n100k_crash"]["n_member"] != 99_000:
        raise AssertionError("the N=100,000 burst did not decide at tick "
                             "113 leaving 99,000 members")
    shared["n100k_drop_flipflop"] = phase_shared(
        "shared_n100k_drop_flipflop", 8, device, rx_account)
    churn = shared["n100k_churn"] = phase_shared(
        "shared_n100k_churn", 9, device, rx_account)
    if len(churn["decides"]) != 24 or churn["n_member"] != 100_000:
        raise AssertionError("the churn run did not decide 24 bursts "
                             "leaving 100,000 members")
    contested = shared["n100k_contested"] = phase_shared(
        "shared_n100k_contested", 10, device, rx_account)
    if len(contested["classic_decides"]) != 8 or \
            len(contested["decides"]) != 8 or \
            contested["classic_decides"][0] != 19 or \
            contested["n_member"] != 99_992:
        raise AssertionError("the contested run did not decide 8 classic "
                             "rounds from tick 19 leaving 99,992 members")

    main_t, wide_t = times[MAIN_N], times[WIDE_N]
    kernels = [{
        "name": "rx_deliver",
        "route": "cuda",
        "source": "rapid_tpu_torch/engine/csrc/rx_deliver.cu",
        "replaces": "rapid_tpu/engine/rx_pallas.py:61",
        "with_wrapper": "rapid_tpu/engine/rx_pallas.py:72",
        "on_main_path": True,
        "launches": main_run["deliver_launches"],
        "max_abs_err": err_deliver,
        "parity": "exact",
        **main_t["rx_deliver"],
        "bound_by": "bytes",
        "library_ms": None,
        "c4096": wide_t["rx_deliver"],
        "composed": {"c1024": main_t["composed"],
                     "c4096": wide_t["composed"]},
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
                    "shared": shared, "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
