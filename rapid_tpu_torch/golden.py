"""The committed golden runs that hold the card to the reference.

``testdata/rx_n64_golden.json`` records the reference's per-receiver
engine on ``faults.crash_window_delay_schedule(64)`` over 160 ticks:
per-tick counters and phase counters, per-slot events and final config
ids. ``testdata/shared_*.json`` record the reference's shared engine on
the ``SHARED`` scenarios over 160 ticks: events, every per-tick scalar of
``StepLog``, the expanded counters, the final config id and a SHA-256 of
every final-state field. The scenarios are crash bursts, probe drop with
a flip-flop window, sustained churn and contested consensus, each in the
shape ``benchmarks/bench_engine.py`` gives it. CPU tests regenerate the
files from the reference and hold the port's CPU runs to them;
``chip_smoke.py`` compares the port's runs on the card against them.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from rapid_tpu_torch.faults import LinkWindow

TESTDATA = Path(__file__).resolve().parent / "testdata"
GOLDEN_PATH = TESTDATA / "rx_n64_golden.json"
GOLDEN_N = 64
GOLDEN_TICKS = 160
SHARED_TICKS = 160
I32_MAX = (1 << 31) - 1


class SharedBoot(NamedTuple):
    """A scenario's boot on a device: what ``simulate`` takes, and the
    host seconds that building the schedule and ``init_state`` took."""

    state: object
    faults: object
    churn: object           # a ChurnSchedule of tensors, or None
    fallback: object        # a FallbackSchedule of tensors, or None
    setup_s: float


@dataclass(frozen=True)
class SharedScenario:
    """One shared-engine run: ``n`` slots with ``synthetic_uids`` and
    identifier sum 0, default ``Settings()``. Slots
    ``range(0, n, crash_every)`` crash at ``crash_tick`` (none when
    ``crash_every`` is 0); ``drop_p``/``drop_seed`` drop probes;
    ``flip_flop`` adds one one-way window from the first ``n // 100``
    slots to the rest, from tick 20, flipping every 20 ticks.

    ``churn_burst`` > 0 is ``bench_engine.run_churn``: ``capacity``
    slots, members ``[0, n)``, and ``churn.synthetic_churn_schedule``'s
    alternating join and leave bursts of that many slots from tick 10.
    ``contested`` is ``bench_engine.run_contested``:
    ``paxos.synthetic_contested_schedule`` over the run's ticks."""

    name: str
    n: int
    crash_every: int = 0
    crash_tick: int = 5
    drop_p: float = 0.0
    drop_seed: int = 0
    flip_flop: bool = False
    churn_burst: int = 0
    contested: bool = False

    @property
    def path(self) -> Path:
        return TESTDATA / f"{self.name}.json"

    def churn_period(self, settings) -> int:
        return settings.churn_decide_delay_ticks + 3

    def capacity(self, settings) -> int:
        if not self.churn_burst:
            return self.n
        cycles = max(1, (SHARED_TICKS - 10) // (2 * self.churn_period(
            settings)))
        return self.n + cycles * self.churn_burst

    def crash_ticks(self) -> List[int]:
        ticks = [I32_MAX] * self.n
        if self.crash_every:
            for slot in range(0, self.n, self.crash_every):
                ticks[slot] = self.crash_tick
        return ticks

    def windows(self) -> Tuple[LinkWindow, ...]:
        if not self.flip_flop:
            return ()
        cut = self.n // 100
        return (LinkWindow(src_slots=frozenset(range(cut)),
                           dst_slots=frozenset(range(cut, self.n)),
                           start_tick=20, period_ticks=20),)

    def boot(self, device="cuda") -> SharedBoot:
        """The port's boot of this scenario on ``device``."""
        import time

        from rapid_tpu_torch.convert import from_reference
        from rapid_tpu_torch.engine import churn, paxos
        from rapid_tpu_torch.engine.state import (
            EngineFaults, init_state, link_faults)
        from rapid_tpu_torch.identity import synthetic_uids
        from rapid_tpu_torch.settings import Settings

        settings = Settings()
        start = time.perf_counter()
        c = self.capacity(settings)
        uids = synthetic_uids(c)
        member = np.arange(c) < self.n
        churn_sched = fallback = id_fps = None
        if self.churn_burst:
            sched, id_fps, _ = churn.synthetic_churn_schedule(
                c, self.n, settings, start=10, burst=self.churn_burst,
                period=self.churn_period(settings))
            churn_sched = from_reference(sched, device=device)
        if self.contested:
            sched, _ = paxos.synthetic_contested_schedule(
                self.n, settings, SHARED_TICKS, uids=uids)
            fallback = from_reference(sched, device=device)
        state = init_state(uids, 0, settings, member=member, id_fps=id_fps,
                           device=device)
        base = link_faults(self.crash_ticks() + [I32_MAX] * (c - self.n),
                           self.windows(), c, device=device)
        faults = EngineFaults(
            drop_p=self.drop_p, drop_seed=self.drop_seed,
            **{f: getattr(base, f) for f in EngineFaults.FIELDS})
        state.member.sum().item()       # the boot has reached the device
        return SharedBoot(state, faults, churn_sched, fallback,
                          time.perf_counter() - start)


SHARED = {sc.name: sc for sc in (
    # BASELINE configuration 2: 1k nodes, a 1 % crash burst.
    SharedScenario("shared_n1000_crash", 1000, crash_every=100),
    # The same burst at 100k nodes.
    SharedScenario("shared_n100k_crash", 100_000, crash_every=100),
    # BASELINE configuration 4: 100k nodes, flip-flop reachability with
    # probabilistic probe drop p = 0.3.
    SharedScenario("shared_n100k_drop_flipflop", 100_000, drop_p=0.3,
                   drop_seed=7, flip_flop=True),
    # BASELINE configuration 5's concurrent joins: 24 alternating join and
    # leave bursts of 8 slots, at 1k and 100k members.
    SharedScenario("shared_n1000_churn", 1000, churn_burst=8),
    SharedScenario("shared_n100k_churn", 100_000, churn_burst=8),
    # ... and its Fast Paxos fallback: 8 split votes, each decided by the
    # classic round.
    SharedScenario("shared_n1000_contested", 1000, contested=True),
    SharedScenario("shared_n100k_contested", 100_000, contested=True),
)}


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


def load(path: Path = GOLDEN_PATH) -> dict:
    return json.loads(path.read_text())


def state_digests(state) -> Dict[str, str]:
    """SHA-256 of each field of a NamedTuple of numpy arrays (reference
    dtypes), over its dtype, shape and bytes."""
    out = {}
    for name in state._fields:
        arr = np.asarray(getattr(state, name))
        h = hashlib.sha256(f"{arr.dtype}{arr.shape}".encode())
        h.update(arr.tobytes())
        out[name] = h.hexdigest()
    return out


def shared_record(name: str, events, logs, counters, config_id: int,
                  final) -> dict:
    """Canonical JSON-ready form of one shared-engine run: ``events`` as
    dicts, ``logs`` and ``final`` NamedTuples of numpy arrays in the
    reference's dtypes, ``counters`` the expanded per-tick counts."""
    scalars = {f: [int(v) for v in np.asarray(getattr(logs, f))]
               for f in logs._fields if np.ndim(getattr(logs, f)) == 1}
    return {
        "name": name,
        "ticks": len(counters),
        "events": [dict(e) for e in events],
        "log": scalars,
        "counters": [dict(row) for row in counters],
        "config_id": int(config_id),
        "state_sha256": state_digests(final),
    }


def shared_run_record(name: str, final, logs) -> dict:
    """``shared_record`` of a port run (final state and stacked logs)."""
    from rapid_tpu_torch.convert import to_numpy
    from rapid_tpu_torch.engine import diff
    from rapid_tpu_torch.engine.state import state_config_id

    return shared_record(
        name, [e.as_dict() for e in diff.engine_events(logs)],
        to_numpy(logs), diff.expand_counters(logs), state_config_id(final),
        to_numpy(final))


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
        if isinstance(a, dict) and isinstance(b, dict):
            out.extend(f"{key}.{sub}" for sub in differences(a, b))
        elif isinstance(a, list) and isinstance(b, list):
            first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
            out.append(f"{key}[{first}]")
        else:
            out.append(key)
    return out
