"""Where a tick of either engine spends its time on the card.

    python -m rapid_tpu_torch.profile --n 1024 --windows 110:20
    python -m rapid_tpu_torch.profile --engine shared \
        --scenario shared_n100k_crash --windows 105:10,120:40
    python -m rapid_tpu_torch.profile --engine shared --scenario churn \
        --windows 13:5,60:12
    python -m rapid_tpu_torch.profile --engine shared --scenario contested \
        --windows 20:14,34:6

The per-receiver engine (default) lowers
``faults.crash_window_delay_schedule(n)``; the shared engine boots one of
``golden.SHARED``'s scenarios (``churn`` and ``contested`` name the
N=100,000 ones). Each window ``FROM:TICKS`` of ``--windows`` (default
``110:20``: the crash scenarios announce and decide around tick 112)
runs ``FROM`` ticks, then ``TICKS`` more unprofiled (so the
card loads every kernel the window uses before it is measured), then the
same ``TICKS`` again from the same state under ``torch.profiler`` (CPU
and CUDA activities). Prints one JSON line per window: wall ms per tick
(host clock around work that ends in a synchronize), device-busy ms per
tick (the sum of CUDA kernel and memory-operation time, so an upper
bound when streams overlap; there is one stream here), kernel launches
and aten ops per tick, host reads per tick (``device.read_host`` and
``device.read_arrays``), the decides inside the window, and the aten ops
(and the hand-written kernel) with the most device time. A window's
first tick pays once for what a run computes at its start (the shared
engine's config id, its reads of the vote-arrival bit, the epoch and the
schedules).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

#: Short names of the shared engine's N=100,000 churn and contested runs.
SCENARIOS = {"churn": "shared_n100k_churn",
             "contested": "shared_n100k_contested"}


def main(argv=None) -> int:
    import torch

    from rapid_tpu_torch import golden
    from rapid_tpu_torch.engine import receiver, rx_packed, step
    from rapid_tpu_torch.faults import crash_window_delay_schedule
    from rapid_tpu_torch.settings import Settings

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("receiver", "shared"),
                    default="receiver")
    ap.add_argument("--n", type=int, default=1024,
                    help="slots of the per-receiver run")
    ap.add_argument("--scenario", choices=sorted(golden.SHARED)
                    + sorted(SCENARIOS), default="shared_n100k_crash",
                    help="the shared engine's run")
    ap.add_argument("--windows", default="110:20",
                    help="comma-separated FROM:TICKS windows, profiled "
                         "one after the other")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    windows = [tuple(int(x) for x in w.split(":"))
               for w in args.windows.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("profile needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if args.engine == "shared":
        settings = Settings()
        name = SCENARIOS.get(args.scenario, args.scenario)
        n = golden.SHARED[name].n
        boot = golden.SHARED[name].boot()
        sched = dict(churn=boot.churn, fallback=boot.fallback)

        def start(ticks):
            return step.simulate(boot.state, boot.faults, ticks, settings,
                                 **sched)[0]

        def window(state, ticks):
            return lambda: step.simulate(state, boot.faults, ticks, settings,
                                         **sched)[1].decide_now
    else:
        settings = Settings(rx_kernel="pallas")
        name = None
        n = args.n
        member = receiver.lower_receiver_schedule(
            crash_window_delay_schedule(n), settings)

        def start(ticks):
            final, _ = receiver.receiver_simulate(
                member.state, member.faults, ticks, settings)
            return rx_packed.bundle_from_dense(final, settings)

        def window(state, ticks):
            return lambda: receiver.receiver_simulate(
                state, member.faults, ticks, settings)[1].decide
    for first, ticks in windows:
        print(json.dumps(profile_window(
            window(start(first), ticks), ticks, args.top,
            {"card": card, "engine": args.engine, "scenario": name, "n": n,
             "ticks": ticks, "from_tick": first})), flush=True)
    return 0


def profile_window(run, ticks: int, top_k: int, head: dict) -> dict:
    """``run()`` (which returns the window's per-tick decide flags) once
    unprofiled, then once under the profiler; ``head`` and the window's
    figures per tick."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rapid_tpu_torch import device

    run()
    torch.cuda.synchronize()
    reads = device.host_reads
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        decides = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    reads = device.host_reads - reads
    events = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in on_device)
    kernels = sum(e.count for e in on_device)
    cpu_ops = sum(e.count for e in events if e.key.startswith("aten::"))
    # Device time by the aten op that launched it, plus the hand-written
    # kernel, which no aten op launches.
    named = [e for e in events if e.key.startswith("aten::")
             or "rx_account" in e.key]
    top = sorted(named, key=dev_us, reverse=True)[:top_k]
    return {
        **head,
        "decides_in_window": int(decides.sum()),
        "host_reads_per_tick": reads / ticks,
        "wall_ms_per_tick": wall * 1e3 / ticks,
        "device_busy_ms_per_tick": busy / 1e3 / ticks,
        "device_kernels_per_tick": kernels / ticks,
        "aten_ops_per_tick": cpu_ops / ticks,
        "top_device_ops": [{"name": e.key[:80], "count": e.count,
                            "device_ms": dev_us(e) / 1e3}
                           for e in top],
    }


if __name__ == "__main__":
    raise SystemExit(main())
