"""The comparison's control and planted faults, run through a cell's
whole harness with the timed path replaced underneath.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--fault control|unchanged|half|altered ...] [--seconds s]

``control`` puts the plain reference in the program's place with the
configuration's timing guarantees broken: a monitor reports its subject
after ``fd_failure_threshold - 1`` failed probes instead of
``fd_failure_threshold``, and a classic round decides one message delay
early (``classic_round_ticks - 1``), the steps that would shave an
interval off detection or a tick off the fallback. The faults break the
program itself: ``unchanged`` makes each tick function the engine module
declares (``TICK_FUNCTIONS``) return the state it was given; ``half``
computes half of the fleet and repeats those members' outputs for the
other half (in a fleet of one member, half of the rows of its processes'
own state and logs); ``altered`` adds one to a counter of member 0 (the
engine module's ``ALTERED_COLUMN``) where the log is produced. Each must
come out ``correct: false``; the script prints one JSON line per seed and
fault and exits 1 if any comes out correct. On a CPU-only machine it
runs on the CPU (tests do, at a small size).
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import run, system  # noqa: E402

FAULTS = ("control", "unchanged", "half", "altered")


class ControlFleet:
    """The reference, with one stated guarantee broken, in the fleet's
    place: ``dispatch`` runs every member, ``fold`` and ``outputs`` read
    the reference's own results."""

    def __init__(self, config, descs, ticks, device):
        self.config = dict(config, fd_failure_threshold=config[
            "fd_failure_threshold"] - 1)
        if "classic_round_ticks" in config:
            self.config["classic_round_ticks"] -= 1
        self.descs, self.ticks, self.device = descs, ticks, device
        self.model = run.reference_of(config)
        self.lower_s = 0.0

    def dispatch(self):
        return run.reference_outputs(self.config, self.descs, self.ticks,
                                     self.device)

    def fold(self, out):
        return [self.model.member_summary(o) for o in out]

    def outputs(self, out):
        return out


def _halved(out):
    """Half of the batch computed and its outputs repeated for the rest:
    along the member axis of a fleet, or, in a fleet of one member, along
    the axis of its processes (every axis as long as its final view's
    ``member``, after the member axis)."""
    from torch.utils import _pytree

    finals, logs = out[0], out[1]
    members = logs.tick.shape[0]

    def half(x, dim):
        if not torch.is_tensor(x) or x.dim() <= dim:
            return x
        n = x.shape[dim]
        keep = x.narrow(dim, 0, (n + 1) // 2)
        return torch.cat([keep, keep.narrow(dim, 0, n - keep.shape[dim])],
                         dim=dim)
    if members > 1:
        return _pytree.tree_map(lambda x: half(x, 0), out)
    c = int(finals.member.shape[-1])
    rows = lambda dim: (lambda x: half(x, dim) if torch.is_tensor(x) and
                        x.dim() > dim and x.shape[dim] == c else x)
    return (_pytree.tree_map(rows(1), finals),
            _pytree.tree_map(rows(2), logs)) + tuple(out[2:])


def _altered(out, name: str):
    finals, logs = out[0], out[1]
    col = getattr(logs, name).clone()
    col[0, col.shape[1] // 2] += 1
    return (finals, logs._replace(**{name: col})) + tuple(out[2:])


def _frozen(tick):
    def frozen(state, *args, **kw):
        return state, tick(state, *args, **kw)[1]
    return frozen


def _freeze(ticks) -> list:
    """Each ``(module, attribute)`` tick function made to return the
    state it was given; ``[(module, attribute, function)]`` to put
    back."""
    saved = []
    for module_name, name in ticks:
        module = importlib.import_module(module_name)
        tick = getattr(module, name)
        saved.append((module, name, tick))
        setattr(module, name, _frozen(tick))
    return saved


@contextlib.contextmanager
def planted(fault: str):
    """Within the block, the harness drives ``fault`` in place of the
    program's timed path."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    build = system.build
    frozen = []

    def planted_build(config, descs, ticks, device):
        if fault == "control":
            return ControlFleet(config, descs, ticks, device)
        if fault == "unchanged":
            frozen.extend(_freeze(system.engine_of(config).TICK_FUNCTIONS))
        fleet = build(config, descs, ticks, device)
        dispatch = fleet.dispatch
        if fault == "half":
            fleet.dispatch = lambda: _halved(dispatch())
        elif fault == "altered":
            name = fleet.engine.ALTERED_COLUMN
            fleet.dispatch = lambda: _altered(dispatch(), name)
        return fleet
    system.build = planted_build
    try:
        yield
    finally:
        system.build = build
        for module, name, tick in reversed(frozen):
            setattr(module, name, tick)


def check(cell: str, seed: int, fault: str, seconds: float, dev,
          workload=None, config=None, traffic=None) -> dict:
    """One run of ``cell`` with ``fault`` planted: its checks."""
    if workload is None:
        workload, config, traffic = run.load_cell(cell)
    bench = run.load_json(ROOT / "BENCHMARK.json")
    start = time.perf_counter()
    with planted(fault):
        result = run.run_cell(workload, config, traffic, seed, seconds,
                              False, dev, bench, start=start)
    return {"cell": workload["name"], "seed": seed, "fault": fault,
            "correct": result["correct"], "checks": result["checks"],
            "first_mismatches": result["details"]["first_mismatches"][:3],
            "seconds": time.perf_counter() - start}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", nargs="+", choices=FAULTS,
                    default=["control"])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    caught = True
    for fault in args.fault:
        for seed in args.seeds:
            res = check(args.workload, seed, fault, args.seconds, dev)
            caught &= not res["correct"]
            print(json.dumps(res), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
