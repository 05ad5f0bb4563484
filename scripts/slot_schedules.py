#!/usr/bin/env python
"""Wall of one golden scenario on a slot mesh under two schedules of the
shards' threads, each run held bit for bit to the unsplit run.

- ``turns``: the engine's own (``sharding._Rendezvous``). The shards take
  turns at every collective, so one shard's host code runs at a time, in
  rank order, and a shard keeps the turn while it waits for its device.
- ``barrier``: the shards run freely and meet at a ``threading.Barrier``
  at every collective (``_BarrierRendezvous`` below, built only here).
  Any number of shards dispatch or wait at once, so one shard's device
  wait need not hold back the others.

The schedules run in the order turns, barrier, barrier, turns, repeated
``--repeats`` times, so a drift of the machine falls on both alike. With
``--one-thread`` every shard's CPU ops run on one thread, under both
schedules. On ``--device cuda`` the mesh is ``--shards`` entries of the
first card; on the CPU, ``--shards`` entries of the CPU.

    python scripts/slot_schedules.py [--device cpu] [--shards 8]
        [--scenario shared_n1000_crash] [--repeats 2] [--one-thread]

Prints one JSON line per run and, last, a summary with each schedule's
walls in seconds and ms per tick.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rapid_tpu_torch import golden  # noqa: E402
from rapid_tpu_torch.device import resolve_device  # noqa: E402
from rapid_tpu_torch.engine import sharding, simulate  # noqa: E402


class _BarrierRendezvous(sharding._Rendezvous):
    """Free-running shards that meet at a ``threading.Barrier`` at each
    collective. ``SlotGroup._exchange`` posts, hands on the turn and
    waits for its own: here handing on does nothing and waiting is the
    barrier. The two buffers stay safe: a shard writes one again only
    after the next barrier, which every shard reaches after its read."""

    def __init__(self, size: int, timeout: float):
        super().__init__(size, timeout)
        self.barrier = threading.Barrier(size)

    def wait_turn(self, rank: int) -> None:
        try:
            self.barrier.wait(self.timeout)
        except threading.BrokenBarrierError:
            self.broken = True
            raise sharding._Aborted() from None
        if self.broken:
            raise sharding._Aborted()

    def pass_turn(self, rank: int) -> None:
        pass

    def abort(self) -> None:
        self.broken = True
        self.barrier.abort()


@contextlib.contextmanager
def schedule(name: str):
    """Run ``sharding.run_spmd`` under the schedule ``name``."""
    if name == "turns":
        yield
        return
    kept = sharding._Rendezvous
    sharding._Rendezvous = _BarrierRendezvous
    try:
        yield
    finally:
        sharding._Rendezvous = kept


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(sc, boot, mesh, dev):
    _sync(dev)
    start = time.perf_counter()
    out = simulate(boot.state, boot.faults, sc.ticks, sc.settings(),
                   churn=boot.churn, fallback=boot.fallback, mesh=mesh,
                   device=dev)
    _sync(dev)
    return out, time.perf_counter() - start


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        list(a[0]) + list(a[1]), list(b[0]) + list(b[1])))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--shards", type=int, default=8)
    parser.add_argument("--scenario", default="shared_n1000_crash")
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--one-thread", action="store_true")
    args = parser.parse_args(argv)

    dev = sharding.pinned(resolve_device(args.device))
    if args.one_thread:
        torch.set_num_threads(1)
    sc = golden.SCENARIOS[args.scenario]
    boot = sc.boot(device=dev)
    mesh = sharding.slot_mesh(devices=[dev] * args.shards)
    want, unsplit_s = _run(sc, boot, None, dev)
    _run(sc, boot, mesh, dev)  # warm: the first split run pays set-up
    walls = {"turns": [], "barrier": []}
    for _ in range(args.repeats):
        for name in ("turns", "barrier", "barrier", "turns"):
            with schedule(name):
                got, wall = _run(sc, boot, mesh, dev)
            if not _same(got, want):
                raise AssertionError(f"{name}: the split run differs from "
                                     f"the unsplit one")
            walls[name].append(wall)
            print(json.dumps({"schedule": name, "wall_s": wall}))
    print(json.dumps({
        "scenario": sc.name, "ticks": sc.ticks, "device": str(dev),
        "shards": args.shards, "threads": torch.get_num_threads(),
        "unsplit_wall_s": unsplit_s,
        "walls_s": walls,
        "ms_per_tick_median": {
            name: sorted(w)[len(w) // 2] * 1e3 / sc.ticks
            for name, w in walls.items()},
        "equal_to_unsplit": True,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
