"""Where a tick of the per-receiver engine spends its time on the card.

    python -m rapid_tpu_torch.profile --n 1024 --ticks 20

Lowers ``faults.crash_window_delay_schedule(n)``, runs ``--warmup``
ticks, then ``--ticks`` more under ``torch.profiler`` (CPU and CUDA
activities). Prints one JSON line: wall ms per tick (host clock around
work that ends in a synchronize), device-busy ms per tick (the sum of
CUDA kernel and memory-operation time, so an upper bound when streams
overlap; there is one stream here), kernel launches and aten ops per
tick, and the aten ops (and the hand-written kernel) with the most
device time. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rapid_tpu_torch.engine import receiver, rx_packed
    from rapid_tpu_torch.faults import crash_window_delay_schedule
    from rapid_tpu_torch.settings import Settings

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=110,
                    help="ticks run before the profiled window (the "
                         "scenario announces and decides around tick 112)")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile needs a CUDA device")
    settings = Settings(rx_kernel="pallas")
    member = receiver.lower_receiver_schedule(
        crash_window_delay_schedule(args.n), settings)
    final, _ = receiver.receiver_simulate(member.state, member.faults,
                                          args.warmup, settings)
    state = rx_packed.bundle_from_dense(final, settings)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        receiver.receiver_simulate(state, member.faults, args.ticks,
                                   settings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
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
        "card": card, "n": args.n, "ticks": args.ticks,
        "from_tick": args.warmup,
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
