"""Multi-device dry run of the shared engine: one cluster's slot universe
split over a slot mesh, held three ways.

The port's counterpart of the reference's ``dryrun_multichip``
(``__graft_entry__.py``). ``dryrun_multichip(n_devices=8)`` runs BASELINE
config #1 (the 64-node ring with slot 7 crashing at tick 5, 130 ticks)
through ``engine.diff.run_differential`` twice, on a slot mesh of
``n_devices`` (``engine.sharding.slot_mesh``; each of the eight shards
holds 8 slots and ticks on a thread of its own) and without one, and
checks the sharded engine against the host oracle, the unsharded engine
against the oracle, and the two engines against each other (per-tick
counters, events, final configuration id). On success it prints one JSON
line ``{"ok": true, ...}`` with the reference's keys, as the last line of
its output.

The mesh is ``devices`` when given (a device may repeat: eight shards on
one card), else ``n_devices`` visible cards of ``device``'s type, or
``n_devices`` entries of the CPU with ``device="cpu"``. With too few cards
and no ``devices`` listed the dry run degrades: it prints ``{"ok": false,
"skipped": true, "reason": ...}`` and returns. A listed device list that
is too short raises.

    python -m rapid_tpu_torch.multichip [--device cpu] [--n-devices D]

The command exits 0 when the run is ok or skipped, as the reference's
does.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from rapid_tpu_torch.device import resolve_device

SKIP_MARKER = "__GRAFT_DRYRUN_SKIP__"

# BASELINE.json config #1: 64-node ring, slot 7 crashes at tick 5, run
# long enough for detection, the cut decision and the reconfiguration.
BASELINE_N = 64
BASELINE_CRASHES = {7: 5}
BASELINE_TICKS = 130


def _emit(payload: dict) -> dict:
    """Print one JSON result line (newline-terminated) and return it."""
    sys.stdout.write(json.dumps(payload, sort_keys=True) + "\n")
    sys.stdout.flush()
    return payload


def dryrun_multichip(n_devices: int = 8, devices: Optional[Sequence] = None,
                     device="cuda") -> dict:
    """Hold the engine on an ``n_devices``-way slot mesh against the
    oracle and against the unsharded engine; returns the printed result.
    ``ok`` means all three agree bit for bit on BASELINE config #1;
    ``skipped`` that too few cards are visible and none were listed.
    A divergence raises ``AssertionError`` (or the differential's
    ``DivergenceError``)."""
    from rapid_tpu_torch.engine import sharding
    from rapid_tpu_torch.engine.diff import run_differential

    dev = resolve_device(device)
    if devices is None and dev.type == "cuda" and \
            torch.cuda.device_count() < n_devices:
        return _emit({
            "bench": "multichip_dryrun",
            "ok": False,
            "skipped": True,
            "reason": (f"need {n_devices} devices, found "
                       f"{torch.cuda.device_count()}; pass devices= (a "
                       f"card may repeat) or device='cpu'"),
            "marker": SKIP_MARKER,
            "n_devices": n_devices,
            "devices_found": torch.cuda.device_count(),
        })
    mesh = sharding.slot_mesh(n_devices, devices=devices, device=device)

    # Part 1: the sharded engine against the host oracle.
    sharded = run_differential(BASELINE_N, BASELINE_CRASHES, BASELINE_TICKS,
                               mesh=mesh, device=mesh.devices[0])
    sharded.assert_identical()

    # Part 2: the engine on one device against the oracle.
    plain = run_differential(BASELINE_N, BASELINE_CRASHES, BASELINE_TICKS,
                             device=mesh.devices[0])
    plain.assert_identical()

    # Part 3: sharded against one device, bit for bit.
    if plain.engine_counters != sharded.engine_counters:
        bad = [t for t, (a, b) in enumerate(
            zip(plain.engine_counters, sharded.engine_counters)) if a != b]
        raise AssertionError(
            f"sharded vs single-device counter divergence at ticks {bad[:5]}")
    if plain.engine_events != sharded.engine_events:
        raise AssertionError(
            "sharded vs single-device event-log divergence")
    if plain.engine_config_id != sharded.engine_config_id:
        raise AssertionError(
            "sharded vs single-device config-id divergence: "
            f"{plain.engine_config_id} != {sharded.engine_config_id}")

    return _emit({
        "bench": "multichip_dryrun",
        "ok": True,
        "skipped": False,
        "n_devices": n_devices,
        "mesh_axis": sharding.AXIS,
        "n": BASELINE_N,
        "n_ticks": BASELINE_TICKS,
        "crashes": {str(k): v for k, v in BASELINE_CRASHES.items()},
        "config_id": sharded.engine_config_id,
        "counters_checked": len(plain.engine_counters),
    })


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-devices", type=int, default=8,
                        help="shards of the slot mesh (default 8)")
    parser.add_argument("--device", default="cuda",
                        help="torch device type (default cuda; 'cpu' runs "
                             "the shards as entries of the CPU)")
    args = parser.parse_args(argv)
    result = dryrun_multichip(args.n_devices, device=args.device)
    return 0 if (result["ok"] or result["skipped"]) else 1


if __name__ == "__main__":
    sys.exit(main())
