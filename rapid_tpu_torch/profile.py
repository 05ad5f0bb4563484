"""Where a tick of either engine spends its time on the card.

    python -m rapid_tpu_torch.profile --n 1024 --ticks 20
    python -m rapid_tpu_torch.profile --engine shared \
        --scenario shared_n100k_crash --ticks 40

The per-receiver engine (default) lowers
``faults.crash_window_delay_schedule(n)``; the shared engine boots one of
``golden.SHARED``'s scenarios. Either runs ``--warmup`` ticks, then
``--ticks`` more unprofiled (so the card loads every kernel the window
uses before it is measured), then the same ``--ticks`` again from the
same state under ``torch.profiler`` (CPU and CUDA activities).
Prints one JSON line: wall ms per tick (host clock around work that ends
in a synchronize), device-busy ms per tick (the sum of CUDA kernel and
memory-operation time, so an upper bound when streams overlap; there is
one stream here), kernel launches and aten ops per tick, host reads per
tick (``device.read_host``), and the aten ops (and the hand-written
kernel) with the most device time. The window's first tick pays once
for what a run computes at its start (the shared engine's config id and
its read of the vote-arrival bit).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rapid_tpu_torch import device, golden
    from rapid_tpu_torch.engine import receiver, rx_packed, step
    from rapid_tpu_torch.faults import crash_window_delay_schedule
    from rapid_tpu_torch.settings import Settings

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("receiver", "shared"),
                    default="receiver")
    ap.add_argument("--n", type=int, default=1024,
                    help="slots of the per-receiver run")
    ap.add_argument("--scenario", choices=sorted(golden.SHARED),
                    default="shared_n100k_crash",
                    help="the shared engine's run")
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=110,
                    help="ticks run before the profiled window (the "
                         "scenarios announce and decide around tick 112)")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile needs a CUDA device")
    if args.engine == "shared":
        settings = Settings()
        sc = golden.SHARED[args.scenario]
        n = sc.n
        state, faults = sc.boot()
        state, _ = step.simulate(state, faults, args.warmup, settings)
        run = lambda: step.simulate(state, faults, args.ticks, settings)
    else:
        settings = Settings(rx_kernel="pallas")
        n = args.n
        member = receiver.lower_receiver_schedule(
            crash_window_delay_schedule(n), settings)
        final, _ = receiver.receiver_simulate(member.state, member.faults,
                                              args.warmup, settings)
        state = rx_packed.bundle_from_dense(final, settings)
        run = lambda: receiver.receiver_simulate(state, member.faults,
                                                 args.ticks, settings)
    run()
    torch.cuda.synchronize()
    reads = device.host_reads
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run()
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
    top = sorted(named, key=dev_us, reverse=True)[:args.top]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({
        "card": card, "engine": args.engine, "n": n, "ticks": args.ticks,
        "from_tick": args.warmup,
        "host_reads_per_tick": reads / args.ticks,
        "wall_ms_per_tick": wall * 1e3 / args.ticks,
        "device_busy_ms_per_tick": busy / 1e3 / args.ticks,
        "device_kernels_per_tick": kernels / args.ticks,
        "aten_ops_per_tick": cpu_ops / args.ticks,
        "top_device_ops": [{"name": e.key[:80], "count": e.count,
                            "device_ms": dev_us(e) / 1e3}
                           for e in top],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
