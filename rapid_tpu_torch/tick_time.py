"""Wall time per tick of the per-receiver engine on the card, in turns.

    python -m rapid_tpu_torch.tick_time
    python -m rapid_tpu_torch.tick_time --paths default composed --reps 3

Lowers ``faults.crash_window_delay_schedule(1024)`` and runs 160 ticks of
``receiver_simulate`` from the boot state once per path to warm up, then
``--reps`` rounds of the paths in turns, each round in the given order and
then reversed (a, b, b, a). ``default`` is the tree's own delivery;
``composed`` swaps ``rx_account.account_into_composed`` (the packing
around ``account`` and its kernel, once per plane) into the step. Each
run is timed by the host clock around work that ends in a synchronize.
Then ticks 106-120 of each path run under ``torch.profiler``
(``profile.profile_window``): kernels, aten ops and device-busy time per
tick. Prints the card's name and power limit and one JSON line.

``chip_smoke.py`` phase 4 runs the same loop (its earlier runs are the
warm-up) and an 8-tick window, and ``call_us``.
The script uses only entry points that every slice of the port has had
since the first (``default`` needs nothing else), so a copy of it placed
in an older tree of the port times that tree the same way. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

N = 1024
TICKS = 160
WINDOW_FROM, WINDOW_TICKS = 105, 15
PATHS = ("default", "composed")


def path_fn(name: str):
    """The delivery function a path swaps in; None keeps the tree's own."""
    from rapid_tpu_torch.engine import rx_account

    return None if name == "default" else rx_account.account_into_composed


@contextlib.contextmanager
def swapped(fn):
    """Within the block, the step's delivery runs ``fn`` (when given) in
    place of ``rx_account.account_into``."""
    from rapid_tpu_torch.engine import rx_account

    if fn is None:
        yield
        return
    saved = rx_account.account_into
    rx_account.account_into = fn
    try:
        yield
    finally:
        rx_account.account_into = saved


def timed(member, settings, fn=None, state=None, ticks: int = TICKS):
    """``ticks`` ticks of ``receiver_simulate`` from ``state`` (default:
    ``member``'s boot) with ``fn`` swapped in: final state, logs and wall
    ms per tick."""
    import torch

    from rapid_tpu_torch.engine import receiver

    torch.cuda.synchronize()
    start = time.perf_counter()
    with swapped(fn):
        final, logs = receiver.receiver_simulate(
            member.state if state is None else state, member.faults, ticks,
            settings)
    torch.cuda.synchronize()
    return final, logs, (time.perf_counter() - start) * 1e3 / ticks


def in_turns(member, settings, paths, rounds: int,
             check=lambda name, final, logs: None, warm: bool = True) -> dict:
    """Each path once to warm up (unless ``warm`` is False: the caller
    has run them), then ``rounds`` rounds of ``paths`` in order and
    reversed; ``check(name, final, logs)`` sees every run. Returns each
    path's timed ms per tick, in run order."""
    for name in paths if warm else ():
        check(name, *timed(member, settings, path_fn(name))[:2])
    ms = {name: [] for name in paths}
    for _ in range(rounds):
        for name in list(paths) + list(paths)[::-1]:
            final, logs, t = timed(member, settings, path_fn(name))
            check(name, final, logs)
            ms[name].append(t)
    return ms


def call_us(member, settings, name: str) -> dict:
    """One run of ``name`` with each delivery call timed by the host clock
    from call to return (launches are queued, not waited for): calls and
    host µs per call."""
    from rapid_tpu_torch.engine import rx_account

    fn = path_fn(name) or rx_account.account_into
    spent = [0.0, 0]

    def counted(*args):
        start = time.perf_counter()
        out = fn(*args)
        spent[0] += time.perf_counter() - start
        spent[1] += 1
        return out

    timed(member, settings, counted)
    return {"calls": spent[1], "host_us_per_call": spent[0] * 1e6 / spent[1]}


def windows(member, settings, paths, ticks: int = WINDOW_TICKS) -> dict:
    """Ticks ``WINDOW_FROM + 1`` to ``WINDOW_FROM + ticks`` of each path
    under ``torch.profiler``, from one state reached by the tree's own
    delivery."""
    from rapid_tpu_torch import profile
    from rapid_tpu_torch.engine import rx_packed

    state = rx_packed.bundle_from_dense(
        timed(member, settings, ticks=WINDOW_FROM)[0], settings)
    return {name: profile.profile_window(
        lambda: timed(member, settings, path_fn(name), state,
                      ticks)[1].decide,
        ticks, 8, {"path": name, "from_tick": WINDOW_FROM, "ticks": ticks})
        for name in paths}


def main(argv=None) -> int:
    import torch

    from rapid_tpu_torch.engine import receiver
    from rapid_tpu_torch.faults import crash_window_delay_schedule
    from rapid_tpu_torch.settings import Settings

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--paths", nargs="+", choices=PATHS,
                    default=["default"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tick_time needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    settings = Settings(rx_kernel="pallas")
    member = receiver.lower_receiver_schedule(
        crash_window_delay_schedule(N), settings)
    ms = in_turns(member, settings, args.paths, args.reps)
    out = {"card": card, "n": N, "ticks": TICKS, "ms_per_tick": ms,
           "mean_ms_per_tick": {k: sum(v) / len(v) for k, v in ms.items()},
           "window": windows(member, settings, args.paths)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
