"""Fault schedules in slot coordinates: crashes, link windows, link delays.

Own copies of the reference's ``LinkWindow``, ``DelayRule``, the part of
``AdversarySchedule`` the per-receiver engine lowers, and the checks of
``validate_schedule`` that guard what the engine can represent (slots in
range, sane windows and rules, every delay within the delivery ring).
Scripted proposes are not part of the per-receiver envelope: a schedule
that carries them is refused at lowering.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Optional, Tuple

import numpy as np

NEVER_TICK = (1 << 31) - 1  # int32-safe "never" sentinel


@dataclass(frozen=True)
class LinkWindow:
    """One directed reachability window: while active (``start_tick <= t <
    end_tick`` and, when ``period_ticks > 0``, the flip-flop off-phase
    ``((t - start_tick) // period_ticks) % 2 == 0``) messages delivered at
    tick ``t`` from ``src_slots`` to ``dst_slots`` are dropped; ``two_way``
    drops the reverse direction too."""

    src_slots: FrozenSet[int] = frozenset()
    dst_slots: FrozenSet[int] = frozenset()
    start_tick: int = 0
    end_tick: int = NEVER_TICK
    period_ticks: int = 0
    two_way: bool = False


@dataclass(frozen=True)
class DelayRule:
    """One directed per-edge latency rule, evaluated at the send tick: a
    message sent at ``t`` in ``[start_tick, end_tick)`` from ``src_slots``
    to ``dst_slots`` arrives ``delay_ticks`` plus a seeded jitter in
    ``[0, jitter_ticks]`` later than the one-hop baseline;
    ``reverse_delay_ticks >= 0`` delays the reverse direction by that
    base (-1: no reverse delay)."""

    src_slots: FrozenSet[int] = frozenset()
    dst_slots: FrozenSet[int] = frozenset()
    delay_ticks: int = 1
    jitter_ticks: int = 0
    reverse_delay_ticks: int = -1
    start_tick: int = 0
    end_tick: int = NEVER_TICK

    def max_delay(self) -> int:
        """Worst-case extra delay any edge of this rule can draw."""
        return max(self.delay_ticks,
                   max(self.reverse_delay_ticks, 0)) + self.jitter_ticks


@dataclass(frozen=True)
class AdversarySchedule:
    """A seeded fault program over an ``n``-slot universe: ``crashes``
    maps slot -> fail-stop tick, ``windows`` and ``delays`` are link
    rules, ``seed`` keys the per-slot fallback-timer rngs and the per-edge
    jitter hash. ``proposes`` exists only so a schedule that scripts them
    can be refused."""

    n: int
    crashes: Tuple[Tuple[int, int], ...] = ()
    windows: Tuple[LinkWindow, ...] = ()
    proposes: Tuple[object, ...] = ()
    seed: int = 0
    delays: Tuple[DelayRule, ...] = ()

    def crash_tick_array(self) -> np.ndarray:
        ticks = np.full(self.n, NEVER_TICK, dtype=np.int64)
        for slot, tick in self.crashes:
            ticks[slot] = min(ticks[slot], tick)
        return ticks


class DelayBudgetError(ValueError):
    """A delay rule's worst case does not fit the delivery ring, whose
    largest representable extra delay is ``ring_depth - 1``."""

    def __init__(self, ring_depth: int, max_delay: int, base_ticks: int,
                 jitter_ticks: int) -> None:
        self.ring_depth = ring_depth
        self.max_delay = max_delay
        self.base_ticks = base_ticks
        self.jitter_ticks = jitter_ticks
        super().__init__(
            f"delay rule can draw up to {max_delay} extra ticks (base "
            f"{base_ticks} + jitter {jitter_ticks}) but the delivery ring "
            f"holds at most {ring_depth - 1} (depth {ring_depth}); raise "
            f"Settings.delivery_ring_depth or shrink the rule")


def validate_schedule(schedule: AdversarySchedule,
                      ring_depth: Optional[int] = None) -> None:
    """Input validation of crashes, windows and delay rules; with
    ``ring_depth``, a rule whose worst-case draw exceeds ``ring_depth - 1``
    raises ``DelayBudgetError``."""
    n = schedule.n
    for slot, tick in schedule.crashes:
        if not 0 <= slot < n:
            raise ValueError(f"crash slot {slot} outside universe of {n}")
        if tick < 1:
            raise ValueError(f"crash tick {tick} must be >= 1")
    for w in schedule.windows:
        if not w.src_slots or not w.dst_slots:
            raise ValueError("window src_slots/dst_slots must be non-empty")
        for s in w.src_slots | w.dst_slots:
            if not 0 <= s < n:
                raise ValueError(f"window slot {s} outside universe of {n}")
        if w.period_ticks < 0:
            raise ValueError("window period_ticks must be >= 0")
        if w.start_tick >= w.end_tick:
            raise ValueError(
                f"zero-length window: start_tick {w.start_tick} >= "
                f"end_tick {w.end_tick}")
    for r in schedule.delays:
        if not r.src_slots or not r.dst_slots:
            raise ValueError("delay src_slots/dst_slots must be non-empty")
        for s in r.src_slots | r.dst_slots:
            if not 0 <= s < n:
                raise ValueError(f"delay slot {s} outside universe of {n}")
        if r.delay_ticks < 0:
            raise ValueError("delay_ticks must be >= 0")
        if r.jitter_ticks < 0:
            raise ValueError("jitter_ticks must be >= 0")
        if r.reverse_delay_ticks < -1:
            raise ValueError("reverse_delay_ticks must be >= -1 "
                             "(-1 means no reverse delay)")
        if r.start_tick >= r.end_tick:
            raise ValueError(
                f"zero-length delay rule: start_tick {r.start_tick} >= "
                f"end_tick {r.end_tick}")
        if ring_depth is not None and r.max_delay() > ring_depth - 1:
            raise DelayBudgetError(
                ring_depth=ring_depth, max_delay=r.max_delay(),
                base_ticks=max(r.delay_ticks, r.reverse_delay_ticks),
                jitter_ticks=r.jitter_ticks)
    # Two delay rules may not cover the same directed edge in overlapping
    # tick ranges (each rule's implied reverse direction included).
    rules = list(schedule.delays)
    for i, a in enumerate(rules):
        for b in rules[i + 1:]:
            if a.start_tick >= b.end_tick or b.start_tick >= a.end_tick:
                continue
            a_dirs = [(a.src_slots, a.dst_slots)] + (
                [(a.dst_slots, a.src_slots)]
                if a.reverse_delay_ticks >= 0 else [])
            b_dirs = [(b.src_slots, b.dst_slots)] + (
                [(b.dst_slots, b.src_slots)]
                if b.reverse_delay_ticks >= 0 else [])
            for asrc, adst in a_dirs:
                for bsrc, bdst in b_dirs:
                    if (asrc & bsrc) and (adst & bdst):
                        raise ValueError(
                            f"overlapping delay rules cover directed edge "
                            f"{min(asrc & bsrc)}->{min(adst & bdst)} in "
                            f"ticks [{max(a.start_tick, b.start_tick)}, "
                            f"{min(a.end_tick, b.end_tick)})")


def crash_window_delay_schedule(n: int, seed: int = 11) -> AdversarySchedule:
    """The crash + partition + delay scenario, scaled to ``n`` slots: two
    crashes at tick 5 (slots 3n/16 and 14n/16), a two-way window between
    the first n/8 slots and the rest over ticks 20-60, and a delay rule
    (delay 1, jitter 2) from the first n/4 slots to slots [n/4, 10n/16)
    over ticks 5-150. Over 160 ticks it runs probes, alerts, the cut,
    announce, the fast vote and the decide."""
    return AdversarySchedule(
        n=n,
        crashes=((3 * n // 16, 5), (14 * n // 16, 5)),
        windows=(LinkWindow(src_slots=frozenset(range(n // 8)),
                            dst_slots=frozenset(range(n // 8, n)),
                            start_tick=20, end_tick=60, two_way=True),),
        delays=(DelayRule(src_slots=frozenset(range(n // 4)),
                          dst_slots=frozenset(range(n // 4, 10 * n // 16)),
                          delay_ticks=1, jitter_ticks=2,
                          start_tick=5, end_tick=150),),
        seed=seed)
