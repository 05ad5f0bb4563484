#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``rapid_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. the card's name and power limit; build the delivery kernel from
   ``rapid_tpu_torch/engine/csrc/rx_account.cu`` and print the build time;
2. the kernel against its plain PyTorch version on random planes at
   C in {64, 200, 1000, 1024, 4096}, bit for bit (tolerance: exact);
3. the golden run: N=64, 160 ticks of the crash + partition + delay
   scenario against ``rapid_tpu_torch/testdata/rx_n64_golden.json``
   (the reference's counters, phase counters, events and config ids);
4. the main path at full width: N=1024, 160 ticks of the same scenario
   through ``lower_receiver_schedule`` and ``receiver_simulate``; flags
   clear, a view change decided, survivors on one config id, the kernel
   launched 7 times per tick, and the whole run equal to the same run
   with the plain version swapped in;
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

Phases 6-10 print ms per tick (CUDA events around ``simulate``), host
reads per tick, peak allocated memory, the decides and the setup seconds
(the schedule and ``init_state``), and count the hand-written kernel's
launches in each (none: the shared engine has no kernel).

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

TICKS = 160
MAIN_N = 1024
WIDE_N = 4096
WIDE_TICKS = 8
PARITY_WIDTHS = (64, 200, 1000, 1024, 4096)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)


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
    log(f"phase 1: built and loaded {path.name} in {seconds:.2f} s")
    return seconds


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
        log(f"phase 2: C={c} kernel == plain (dv and 3 counts), "
            f"delivered={int(cnt_k[:, 1].sum())}")
    return worst


def run(schedule, settings, ticks: int, device):
    import torch
    from rapid_tpu_torch.engine import receiver

    member = receiver.lower_receiver_schedule(schedule, settings,
                                              device=device)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    final, logs = receiver.receiver_simulate(member.state, member.faults,
                                             ticks, settings)
    end.record()
    end.synchronize()
    return member, final, logs, start.elapsed_time(end) / ticks


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
    from rapid_tpu_torch.engine import receiver
    from rapid_tpu_torch.faults import crash_window_delay_schedule

    schedule = crash_window_delay_schedule(MAIN_N)
    rx_account.launches = 0
    member, final, logs, ms_tick = run(schedule, settings, TICKS, device)
    launches = rx_account.launches
    receiver.check_flags(final.flags)
    if launches != 7 * TICKS:
        raise AssertionError(f"kernel launched {launches} times, want "
                             f"{7 * TICKS}")
    decided = int(logs.decide.sum())
    if decided < 1:
        raise AssertionError("no view change decided")
    stopped = final.stopped.cpu().numpy()[:MAIN_N]
    crashed = schedule.crash_tick_array() <= TICKS
    ids = np.array(receiver.receiver_config_ids(final)[:MAIN_N], np.uint64)
    survivors = ~stopped & ~crashed
    if len(set(ids[survivors].tolist())) != 1:
        raise AssertionError("survivors disagree on the config id")
    log(f"phase 4: N={MAIN_N} x {TICKS} ticks: {ms_tick:.2f} ms/tick, "
        f"{launches} kernel launches, {decided} slot decides, "
        f"{int(survivors.sum())} survivors on one config id")

    plain_kernel = rx_account.account_packed
    rx_account.account_packed = rx_account.account_plain
    try:
        final_p, logs_p = receiver.receiver_simulate(
            member.state, member.faults, TICKS, settings)
    finally:
        rx_account.account_packed = plain_kernel
    if not (same_run(final, final_p) and same_run(logs, logs_p)):
        raise AssertionError("kernel run != plain-version run")
    log("phase 4: whole run equals the run with account_plain swapped in")
    return {"launches": launches, "ms_per_tick": ms_tick,
            "decided": decided}


def phase_wide(settings, device) -> dict:
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
    _, final, logs, ms_tick = run(schedule, settings, WIDE_TICKS, device)
    peak = torch.cuda.max_memory_allocated()
    receiver.check_flags(final.flags)
    edges = logs.partitioned_edges.cpu().numpy()
    want = np.array([cut * (n - cut) if t >= 3 else 0
                     for t in range(1, WIDE_TICKS + 1)])
    if not np.array_equal(edges, want):
        raise AssertionError(f"partitioned edges {edges} != {want}")
    if len(set(receiver.receiver_config_ids(final))) != 1:
        raise AssertionError("config ids diverged without a decide")
    log(f"phase 5: N={n} x {WIDE_TICKS} ticks: {ms_tick:.1f} ms/tick, "
        f"peak {peak / 2**30:.2f} GiB")
    return {"ms_per_tick": ms_tick, "peak_bytes": peak}


def kernel_times(rx_account, device) -> dict:
    """Per launch at the main path's width and at C=4096: device time of
    the kernel and of the plain version (CUDA graph replay), and the
    wrapper's time per call with its host overhead (CUDA events around
    eager calls). Launches made here are not counted."""
    out = {}
    saved = rx_account.launches
    for c in (MAIN_N, WIDE_N):
        planes = random_planes(c, seed=7, device=device)
        ms = graph_ms(lambda: rx_account.account_kernel(*planes))
        plain = graph_ms(lambda: rx_account.account_plain(*planes))
        call = cuda_ms(lambda: rx_account.account_kernel(*planes), 200)
        out[c] = {"ms": ms, "plain_ms": plain, "call_ms": call,
                  "bound_ms": bound_ms(c)}
        log(f"kernel C={c}: {ms * 1e3:.2f} us/launch on the device, "
            f"{call * 1e3:.2f} us per wrapper call, plain {plain * 1e3:.2f}"
            f" us, bound {bound_ms(c) * 1e3:.3f} us")
    rx_account.launches = saved
    return out


def phase_shared(name: str, phase: int, device, rx_account) -> dict:
    """One golden scenario through the shared engine's entry points, with
    the kernel's launch count zeroed just before the run and read after."""
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
    rx_account.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    final, logs = simulate(boot.state, boot.faults, golden.SHARED_TICKS,
                           Settings(), churn=boot.churn,
                           fallback=boot.fallback)
    end.record()
    end.synchronize()
    launches = rx_account.launches
    ms_tick = start.elapsed_time(end) / golden.SHARED_TICKS
    reads = (device_mod.host_reads - reads) / golden.SHARED_TICKS
    peak = torch.cuda.max_memory_allocated()
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
        f"{launches} kernel launches")
    if boot.fallback is not None:
        log(f"phase {phase}: consensus messages sent by phase {totals}")
    return {"n": sc.n, "ticks": golden.SHARED_TICKS, "ms_per_tick": ms_tick,
            "host_reads_per_tick": reads, "peak_bytes": peak,
            "setup_s": boot.setup_s, "decides": decides,
            "classic_decides": classic, "phase_sent": totals,
            "n_member": rec["log"]["n_member"][-1],
            "rx_account_launches": launches}


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
    max_err = phase_parity(rx_account, device)
    phase_golden(settings, device)
    main_run = phase_main(rx_account, settings, device)
    wide = phase_wide(settings, device)
    times = kernel_times(rx_account, device)
    shared = {"n1000": phase_shared("shared_n1000_crash", 6, device,
                                    rx_account)}
    # The shared engine's paths run no hand-written kernel: each phase
    # zeroes the count before its run and reads it after all the same.
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

    kernel = {
        "name": "rx_account",
        "route": "cuda",
        "source": "rapid_tpu_torch/engine/csrc/rx_account.cu",
        "replaces": "rapid_tpu/engine/rx_pallas.py:61",
        "launches": main_run["launches"],
        "max_abs_err": max_err,
        "parity": "exact",
        "ms": times[MAIN_N]["ms"],
        "plain_ms": times[MAIN_N]["plain_ms"],
        "call_ms": times[MAIN_N]["call_ms"],
        "bound_ms": times[MAIN_N]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "c4096": times[WIDE_N],
    }
    log(json.dumps({"main_path": {"n": MAIN_N, "ticks": TICKS, **main_run},
                    "wide": {"n": WIDE_N, "ticks": WIDE_TICKS, **wide},
                    "shared": shared, "card": card}))
    print(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
