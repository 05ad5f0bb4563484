"""The committed golden run that holds the card to the reference.

``testdata/rx_n64_golden.json`` records the reference engine's per-tick
counters, per-tick phase counters, per-slot events and final config ids
on ``faults.crash_window_delay_schedule(64)`` over 160 ticks. A CPU test
regenerates it from the reference and checks it is unchanged;
``chip_smoke.py`` compares the port's run on the card against it.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List

GOLDEN_PATH = Path(__file__).resolve().parent / "testdata" / \
    "rx_n64_golden.json"
GOLDEN_N = 64
GOLDEN_TICKS = 160


def record(events, counters, phase_counters, config_ids, n: int) -> dict:
    """Canonical JSON-ready form of one run's host-side results."""
    return {
        "n": n,
        "ticks": len(counters),
        "counters": [dict(row) for row in counters],
        "phase_counters": [dict(row) for row in phase_counters],
        "events": [[[int(t), kind, int(cfg), [int(s) for s in slots]]
                    for t, kind, cfg, slots in events[slot]]
                   for slot in range(n)],
        "config_ids": [int(x) for x in config_ids[:n]],
    }


def run_record(final, logs, n: int) -> dict:
    """``record`` of a port run (final dense state and stacked logs)."""
    from rapid_tpu_torch.engine import receiver

    return record(receiver.receiver_events(logs),
                  receiver.receiver_counters(logs),
                  receiver.receiver_phase_counters(logs),
                  receiver.receiver_config_ids(final), n)


def load() -> dict:
    return json.loads(GOLDEN_PATH.read_text())


def dumps(rec: dict) -> str:
    return json.dumps(rec, sort_keys=True, separators=(",", ":")) + "\n"


def differences(got: dict, want: dict) -> List[str]:
    """Names of the sections (and first differing tick or slot) in which
    two records differ; empty when they are equal."""
    out = []
    for key in sorted(set(got) | set(want)):
        a, b = got.get(key), want.get(key)
        if a == b:
            continue
        if isinstance(a, list) and isinstance(b, list):
            first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
            out.append(f"{key}[{first}]")
        else:
            out.append(key)
    return out
