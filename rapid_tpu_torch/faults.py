"""Fault-injection: the oracle's fault models and the slot-coordinate
schedules, with the seeded samplers that draw them.

Own copies of the reference's ``faults`` module. The host referee's
``FaultModel`` family (``HEALTHY``, ``CrashFault``, ``PacketDropFault``,
``OneWayPartitionFault``, ``FlipFlopFault``, ``ComposedFault``,
``correlated_rack_failure``, ``LinkWindowFault``, ``LinkDelayFault``)
answers ``is_crashed``, ``edge_ok`` and ``delay_of`` per message, and
materializes crash and edge masks for a slot universe; probabilistic
drops hash ``(seed, src uid, dst uid, tick)``, so every side samples the
same drops without sharing rng state. ``link_windows_of`` lowers a
model's link rules to ``LinkWindow`` normal form.

The schedule half: ``LinkWindow``, ``DelayRule``, ``ScriptedPropose``,
``AdversarySchedule`` (with ``fault_model``, its oracle-side twin) and
``validate_schedule`` (slots in range, sane windows, rules and proposes,
no two static windows or delay rules on one edge at once, every delay
within the delivery ring); ``random_adversary_schedule``, the campaign
sampler ``sample_adversary_schedule`` with its ``ScenarioWeights``, and
``two_zone_schedule``; and ``delay_of_slots``, the host rule for one
edge's delay. Each sampler draws from one ``random.Random(seed)`` stream
in the reference's order, so a seed gives the reference's schedule.
``fleet.lower_schedule`` compiles proposes into a fallback instance;
``fleet.lower_receiver_schedule`` refuses them.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import (Callable, Dict, FrozenSet, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from rapid_tpu_torch import hashing
from rapid_tpu_torch.identity import uid_of
from rapid_tpu_torch.types import Endpoint

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

    def active(self, tick: int) -> bool:
        if not (self.start_tick <= tick < self.end_tick):
            return False
        if self.period_ticks <= 0:
            return True
        return ((tick - self.start_tick) // self.period_ticks) % 2 == 0

    def blocks(self, src_slot: int, dst_slot: int, tick: int) -> bool:
        if not self.active(tick):
            return False
        if src_slot in self.src_slots and dst_slot in self.dst_slots:
            return True
        return self.two_way and src_slot in self.dst_slots and \
            dst_slot in self.src_slots


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

    def active(self, tick: int) -> bool:
        return self.start_tick <= tick < self.end_tick

    def max_delay(self) -> int:
        """Worst-case extra delay any edge of this rule can draw."""
        return max(self.delay_ticks,
                   max(self.reverse_delay_ticks, 0)) + self.jitter_ticks


def _delay_jitter(seed: int, src_slot: int, dst_slot: int, tick: int,
                  bound: int) -> int:
    """Uniform draw from ``[0, bound]`` for edge (src, dst) at the send
    tick: the host form of ``engine.monitor.delay_matrix``'s hash."""
    if bound <= 0:
        return 0
    h = hashing.hash64(
        src_slot ^ hashing.hash64(dst_slot, seed=tick & hashing.MASK64),
        seed=(seed ^ 0x6A1770) & hashing.MASK64)
    return int((h >> 32) % (bound + 1))


def delay_of_slots(delays: Sequence[DelayRule], seed: int, src_slot: int,
                   dst_slot: int, tick: int) -> int:
    """Extra delivery delay of a message sent ``src -> dst`` at ``tick``:
    per rule the forward direction before the reverse one, across rules
    the maximum (the combining order of ``monitor.delay_matrix``)."""
    best = 0
    for r in delays:
        if not r.active(tick):
            continue
        if src_slot in r.src_slots and dst_slot in r.dst_slots:
            base = r.delay_ticks
        elif r.reverse_delay_ticks >= 0 and src_slot in r.dst_slots \
                and dst_slot in r.src_slots:
            base = r.reverse_delay_ticks
        else:
            continue
        best = max(best, base + _delay_jitter(seed, src_slot, dst_slot,
                                              tick, r.jitter_ticks))
    return best


@dataclass(frozen=True)
class ScriptedPropose:
    """One scripted consensus propose: slot ``slot`` proposes the removal
    of ``proposal`` (ascending slot tuple) at tick ``tick`` with an
    explicit classic-fallback timer delay of ``delay_ticks``."""

    slot: int
    tick: int
    proposal: Tuple[int, ...]
    delay_ticks: int


@dataclass(frozen=True)
class AdversarySchedule:
    """A seeded fault program over an ``n``-slot universe: ``crashes``
    maps slot -> fail-stop tick, ``windows`` and ``delays`` are link
    rules, ``proposes`` scripted consensus proposes, ``seed`` keys the
    per-slot fallback-timer rngs and the per-edge jitter hash."""

    n: int
    crashes: Tuple[Tuple[int, int], ...] = ()
    windows: Tuple[LinkWindow, ...] = ()
    proposes: Tuple[ScriptedPropose, ...] = ()
    seed: int = 0
    delays: Tuple[DelayRule, ...] = ()

    def crash_tick_array(self) -> np.ndarray:
        ticks = np.full(self.n, NEVER_TICK, dtype=np.int64)
        for slot, tick in self.crashes:
            ticks[slot] = min(ticks[slot], tick)
        return ticks

    def fault_model(self, endpoints: Sequence[Endpoint]) -> "FaultModel":
        """The oracle-side ``FaultModel`` of this schedule."""
        crash = CrashFault({endpoints[slot]: tick
                            for slot, tick in self.crashes})
        models: List[FaultModel] = [crash, LinkWindowFault(self.windows)]
        if self.delays:
            models.append(LinkDelayFault(self.delays, self.seed))
        return ComposedFault(models)


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


def _overlapping_edge(a_dirs, b_dirs):
    """The first directed edge two rules both cover, or None."""
    for asrc, adst in a_dirs:
        for bsrc, bdst in b_dirs:
            if (asrc & bsrc) and (adst & bdst):
                return min(asrc & bsrc), min(adst & bdst)
    return None


def validate_schedule(schedule: AdversarySchedule,
                      ring_depth: Optional[int] = None) -> None:
    """Input validation of crashes, windows, proposes and delay rules:
    slots exist, crashes and proposes land at tick >= 1, proposals are
    non-empty ascending slot tuples, at most one scripted propose per
    slot, and no two static windows (or two delay rules) cover one
    directed edge at overlapping ticks. With ``ring_depth``, a rule whose
    worst-case draw exceeds ``ring_depth - 1`` raises
    ``DelayBudgetError``."""
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
    # Flip-flop windows are exempt: their phases make simultaneous
    # coverage intentional.
    static = [w for w in schedule.windows if w.period_ticks == 0]
    for i, a in enumerate(static):
        for b in static[i + 1:]:
            if a.start_tick >= b.end_tick or b.start_tick >= a.end_tick:
                continue
            edge = _overlapping_edge(
                [(a.src_slots, a.dst_slots)]
                + ([(a.dst_slots, a.src_slots)] if a.two_way else []),
                [(b.src_slots, b.dst_slots)]
                + ([(b.dst_slots, b.src_slots)] if b.two_way else []))
            if edge is not None:
                raise ValueError(
                    f"overlapping static windows cover directed edge "
                    f"{edge[0]}->{edge[1]} in ticks "
                    f"[{max(a.start_tick, b.start_tick)}, "
                    f"{min(a.end_tick, b.end_tick)})")
    per_slot: Dict[int, int] = {}
    seen: Set[Tuple[int, int]] = set()
    for p in schedule.proposes:
        if not 0 <= p.slot < n:
            raise ValueError(f"propose slot {p.slot} outside universe of {n}")
        if p.tick < 1:
            raise ValueError(f"propose tick {p.tick} must be >= 1")
        if not p.proposal or list(p.proposal) != sorted(set(p.proposal)):
            raise ValueError("proposal must be a non-empty ascending tuple")
        if any(not 0 <= s < n for s in p.proposal):
            raise ValueError("proposal slot outside universe")
        if p.delay_ticks < 0:
            raise ValueError("delay_ticks must be >= 0")
        if (p.slot, p.tick) in seen:
            raise ValueError(f"two scripted proposes on slot {p.slot} at "
                             f"tick {p.tick}")
        seen.add((p.slot, p.tick))
        per_slot[p.slot] = per_slot.get(p.slot, 0) + 1
        if per_slot[p.slot] > 1:
            raise ValueError(f"more than one scripted propose on slot "
                             f"{p.slot} (device schedule capacity)")
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
            edge = _overlapping_edge(
                [(a.src_slots, a.dst_slots)]
                + ([(a.dst_slots, a.src_slots)]
                   if a.reverse_delay_ticks >= 0 else []),
                [(b.src_slots, b.dst_slots)]
                + ([(b.dst_slots, b.src_slots)]
                   if b.reverse_delay_ticks >= 0 else []))
            if edge is not None:
                raise ValueError(
                    f"overlapping delay rules cover directed edge "
                    f"{edge[0]}->{edge[1]} in ticks "
                    f"[{max(a.start_tick, b.start_tick)}, "
                    f"{min(a.end_tick, b.end_tick)})")


def random_adversary_schedule(n: int, seed: int, ticks: int,
                              fd_interval: int = 10) -> AdversarySchedule:
    """Sample an unscripted fault schedule: a crash burst that may straddle
    an FD-interval boundary, a one-way partition of a random ring subset,
    and (sometimes) a flip-flop link window. Deterministic in ``seed``."""
    rng = random.Random(seed)
    crashes: List[Tuple[int, int]] = []
    n_crash = rng.randint(1, max(1, n // 16))
    burst_start = rng.randint(1, max(1, fd_interval))
    for slot in rng.sample(range(n), n_crash):
        # Half the crashes land after the next FD boundary -> straddling.
        tick = burst_start + (fd_interval if rng.random() < 0.5 else 0)
        crashes.append((slot, tick))
    windows: List[LinkWindow] = []
    if rng.random() < 0.75:
        size = rng.randint(2, max(2, n // 4))
        iso = frozenset(rng.sample(range(n), size))
        rest = frozenset(range(n)) - iso
        windows.append(LinkWindow(src_slots=rest, dst_slots=iso,
                                  start_tick=rng.randint(1, fd_interval)))
    if rng.random() < 0.25:
        size = rng.randint(1, max(1, n // 8))
        t = frozenset(rng.sample(range(n), size))
        windows.append(LinkWindow(
            src_slots=frozenset(range(n)) - t, dst_slots=t,
            start_tick=rng.randint(1, ticks // 2),
            period_ticks=rng.randint(2, 4) * fd_interval))
    schedule = AdversarySchedule(n=n, crashes=tuple(sorted(crashes)),
                                 windows=tuple(windows), seed=seed)
    validate_schedule(schedule)
    return schedule


@dataclass(frozen=True)
class ScenarioWeights:
    """Sampling weights over the scenario-space kinds of
    ``sample_adversary_schedule``. Zero removes a kind; weights need not
    normalize. The default mix exercises every kind.

    Field names are one-to-one with ``SCENARIO_KINDS`` (and, for the
    latency family, ``DELAY_KINDS``): adding a kind means adding a field
    here, a branch in the sampler, and an entry in the kind table."""

    crash: float = 1.0
    partition: float = 1.0
    flip_flop: float = 1.0
    contested: float = 1.0
    churn: float = 1.0
    delay: float = 1.0
    jitter: float = 1.0
    slow_asym: float = 1.0

    def items(self) -> Tuple[Tuple[str, float], ...]:
        pairs = (("crash", self.crash), ("partition", self.partition),
                 ("flip_flop", self.flip_flop), ("contested", self.contested),
                 ("churn", self.churn), ("delay", self.delay),
                 ("jitter", self.jitter), ("slow_asym", self.slow_asym))
        out = tuple((k, w) for k, w in pairs if w > 0)
        if not out:
            raise ValueError("all scenario weights are zero")
        return out


DEFAULT_SCENARIO_WEIGHTS = ScenarioWeights()

#: Every kind `sample_adversary_schedule` can draw, in ScenarioWeights
#: field order; campaign forced-weight sweeps iterate this.
SCENARIO_KINDS = ("crash", "partition", "flip_flop", "contested", "churn",
                  "delay", "jitter", "slow_asym")

#: The latency-family subset: members whose schedule carries DelayRules.
DELAY_KINDS = ("delay", "jitter", "slow_asym")


@dataclass(frozen=True)
class SampledScenario:
    """One draw from scenario space: the fault program plus the sampled
    kind and whether the campaign should pair it with a churn schedule
    (churn lives in ``engine.churn.ChurnSchedule``, outside the
    ``AdversarySchedule`` surface the host referee replays)."""

    kind: str
    schedule: AdversarySchedule
    wants_churn: bool = False


def _sample_crash_burst(rng, n: int, fd_interval: int) -> List[Tuple[int, int]]:
    crashes: List[Tuple[int, int]] = []
    n_crash = rng.randint(1, max(1, n // 16))
    burst_start = rng.randint(1, max(1, fd_interval))
    for slot in rng.sample(range(n), n_crash):
        tick = burst_start + (fd_interval if rng.random() < 0.5 else 0)
        crashes.append((slot, tick))
    return sorted(crashes)


def sample_adversary_schedule(
        n: int, seed: int, ticks: int,
        weights: Optional[ScenarioWeights] = None,
        fd_interval: int = 10, ring_depth: int = 4) -> SampledScenario:
    """Seeded scenario-space sampler for Monte-Carlo fleet campaigns.

    Draws a scenario *kind* from ``weights`` — the full kind table is
    ``SCENARIO_KINDS``, in ``ScenarioWeights`` field order:

    - ``crash``      — one correlated crash burst;
    - ``partition``  — an isolated subset (sometimes healing mid-run,
      sometimes with a crash burst on top);
    - ``flip_flop``  — a periodically flapping link window;
    - ``contested``  — 2-3 camps proposing conflicting removals with
      explicit fallback delays (no fast quorum, classic round recovers);
    - ``churn``      — join/leave traffic (``wants_churn=True``; the
      churn schedule itself lives in ``engine.churn.ChurnSchedule``,
      outside the ``AdversarySchedule`` surface), sometimes under a
      light crash;
    - ``delay`` / ``jitter`` / ``slow_asym`` — the latency family
      (``DELAY_KINDS``): fixed slow subsets, bounded per-message jitter,
      and asymmetric slow links, all bounded by ``ring_depth`` and paired
      with a crash burst so each regime exercises a view change.

    Knob fills (burst sizes, subsets, periods, camp splits, delay bounds)
    come from the same ``random.Random(seed)`` stream — fully
    deterministic in ``seed``. Every returned schedule passes
    ``validate_schedule`` with the given ``ring_depth``.
    ``random_adversary_schedule`` above is the fixed crash+partition mix;
    this sampler is the campaign-facing superset.
    """
    weights = weights or DEFAULT_SCENARIO_WEIGHTS
    rng = random.Random(seed)
    pairs = weights.items()
    kind = rng.choices([k for k, _ in pairs], [w for _, w in pairs])[0]

    crashes: List[Tuple[int, int]] = []
    windows: List[LinkWindow] = []
    proposes: List[ScriptedPropose] = []
    delays: List[DelayRule] = []
    wants_churn = False
    if kind == "crash":
        crashes = _sample_crash_burst(rng, n, fd_interval)
    elif kind == "partition":
        size = rng.randint(2, max(2, n // 3))
        iso = frozenset(rng.sample(range(n), size))
        rest = frozenset(range(n)) - iso
        end = NEVER_TICK
        if rng.random() < 0.3:  # sometimes the partition heals mid-run
            end = max(2, ticks // 2)
        windows.append(LinkWindow(
            src_slots=rest, dst_slots=iso,
            start_tick=rng.randint(1, fd_interval), end_tick=end,
            two_way=rng.random() < 0.3))
        if rng.random() < 0.5:
            crashes = _sample_crash_burst(rng, n, fd_interval)
    elif kind == "flip_flop":
        size = rng.randint(1, max(1, n // 8))
        t = frozenset(rng.sample(range(n), size))
        windows.append(LinkWindow(
            src_slots=frozenset(range(n)) - t, dst_slots=t,
            start_tick=rng.randint(1, max(1, ticks // 2)),
            period_ticks=rng.randint(1, 4) * fd_interval,
            two_way=rng.random() < 0.5))
        if rng.random() < 0.3:
            crashes = _sample_crash_burst(rng, n, fd_interval)
    elif kind == "contested":
        # Split the electorate into camps proposing conflicting removals:
        # no camp reaches the fast quorum, timers with explicit delays
        # fire, and the classic-Paxos fallback recovers.
        n_camps = rng.randint(2, 3)
        victims = sorted(rng.sample(range(n), n_camps))
        tick0 = rng.randint(2, max(2, fd_interval))
        for slot in range(n):
            camp = rng.randrange(n_camps)
            proposes.append(ScriptedPropose(
                slot=slot, tick=tick0, proposal=(victims[camp],),
                delay_ticks=rng.randint(1, 3 * fd_interval)))
    elif kind == "churn":
        wants_churn = True
        if rng.random() < 0.4:  # churn under a light late crash
            slot = rng.randrange(n)
            crashes = [(slot, rng.randint(1, max(1, fd_interval)))]
    elif kind == "delay":
        # A fixed-latency slow subset: every message into (and, half the
        # time, out of) the subset arrives `base` ticks late. No jitter,
        # so ordering is preserved — the pure tail-latency regime.
        size = rng.randint(1, max(1, n // 4))
        slow = frozenset(rng.sample(range(n), size))
        rest = frozenset(range(n)) - slow
        base = rng.randint(1, max(1, ring_depth - 1))
        delays.append(DelayRule(
            src_slots=rest, dst_slots=slow, delay_ticks=base,
            reverse_delay_ticks=base if rng.random() < 0.5 else -1,
            start_tick=rng.randint(0, fd_interval)))
        # Every latency member pairs its rule with a crash burst so the
        # regime exercises a full view change under latency — the
        # campaign's per-regime ticks-to-first-decide tails come from
        # these decides.
        crashes = _sample_crash_burst(rng, n, fd_interval)
    elif kind == "jitter":
        # Bounded per-message jitter on a subset's inbound edges: draws
        # differ tick to tick, so consecutive messages on one edge can
        # swap arrival order — the reordering regime.
        size = rng.randint(1, max(1, n // 4))
        t = frozenset(rng.sample(range(n), size))
        jit = rng.randint(1, max(1, ring_depth - 2))
        base = rng.randint(0, ring_depth - 1 - jit)
        delays.append(DelayRule(
            src_slots=frozenset(range(n)) - t, dst_slots=t,
            delay_ticks=base, jitter_ticks=jit,
            reverse_delay_ticks=base if rng.random() < 0.5 else -1,
            start_tick=rng.randint(0, fd_interval)))
        crashes = _sample_crash_burst(rng, n, fd_interval)
    elif kind == "slow_asym":
        # Slow-link asymmetry: traffic toward one half is slower than the
        # return path (possibly instant), mimicking a congested uplink.
        half = frozenset(rng.sample(range(n), max(1, n // 2)))
        fwd = rng.randint(1, max(1, ring_depth - 1))
        rev = rng.choice([d for d in range(ring_depth) if d != fwd])
        delays.append(DelayRule(
            src_slots=frozenset(range(n)) - half, dst_slots=half,
            delay_ticks=fwd, reverse_delay_ticks=rev,
            start_tick=rng.randint(0, fd_interval)))
        crashes = _sample_crash_burst(rng, n, fd_interval)
    else:  # pragma: no cover - items() only yields the kinds above
        raise AssertionError(kind)

    schedule = AdversarySchedule(
        n=n, crashes=tuple(crashes), windows=tuple(windows),
        proposes=tuple(proposes), seed=seed, delays=tuple(delays))
    validate_schedule(schedule, ring_depth=ring_depth)
    return SampledScenario(kind=kind, schedule=schedule,
                           wants_churn=wants_churn)


def two_zone_schedule(n: int, seed: int, ticks: int,
                      ring_depth: int = 4,
                      fd_interval: int = 10) -> AdversarySchedule:
    """The named two-zone deployment scenario as a concrete schedule.

    Splits the universe into ``zone_a = [0, n//2)`` and
    ``zone_b = [n//2, n)`` — two racks behind one congested uplink:

    - intra-zone traffic is *fast* (no rule: one-hop baseline both ways);
    - cross-zone traffic gets one slow-asym ``DelayRule`` — the a->b
      direction carries the congested base, the return path a strictly
      smaller one, both directions sharing a small jitter bound so
      cross-zone messages also reorder;
    - one correlated crash burst inside ``zone_b`` (a quarter of the
      zone, same tick) — the rack-level analogue of the traffic
      generator's correlated leave bursts, forcing view changes whose
      evidence must cross the slow uplink.

    Knob draws come from ``random.Random(seed)`` so campaigns get a
    family of two-zone instances, but the zone split itself is fixed.
    The schedule is validated against ``ring_depth`` before it is
    returned — a delivery ring too shallow for the drawn worst case
    raises ``DelayBudgetError`` up front, which is how callers size
    ``Settings.delivery_ring_depth`` for this preset.
    """
    if n < 4:
        raise ValueError(f"two_zone needs n >= 4 (got {n})")
    rng = random.Random(seed)
    zone_a = frozenset(range(n // 2))
    zone_b = frozenset(range(n // 2, n))
    jitter = 1 if ring_depth >= 3 else 0
    fwd = rng.randint(2, max(2, ring_depth - 1 - jitter))
    rev = rng.randint(1, fwd - 1) if fwd > 1 else 0
    delays = (DelayRule(src_slots=zone_a, dst_slots=zone_b,
                        delay_ticks=fwd, jitter_ticks=jitter,
                        reverse_delay_ticks=rev, start_tick=0),)
    burst_tick = rng.randint(1, max(1, min(fd_interval, ticks - 1)))
    n_crash = max(1, len(zone_b) // 4)
    crashes = tuple(sorted(
        (slot, burst_tick)
        for slot in rng.sample(sorted(zone_b), n_crash)))
    schedule = AdversarySchedule(n=n, crashes=crashes, seed=seed,
                                 delays=delays)
    validate_schedule(schedule, ring_depth=ring_depth)
    return schedule


#: Named scenario mixes for campaigns. ``"two_zone"`` biases the sampler
#: toward the slow-asym latency regime with crash pressure — the weights
#: twin of the concrete ``two_zone_schedule`` instance family (which
#: differential tests validate directly at N=64).
SCENARIO_WEIGHT_PRESETS: Dict[str, ScenarioWeights] = {
    "default": DEFAULT_SCENARIO_WEIGHTS,
    "two_zone": ScenarioWeights(
        crash=1.0, partition=0.0, flip_flop=0.0, contested=0.0,
        churn=0.0, delay=0.0, jitter=0.0, slow_asym=3.0),
}


def scenario_weights_preset(name: str) -> ScenarioWeights:
    """Look up a named ``ScenarioWeights`` preset; raises with the
    catalogue on an unknown name."""
    try:
        return SCENARIO_WEIGHT_PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario-weights preset {name!r}; known presets: "
            f"{sorted(SCENARIO_WEIGHT_PRESETS)}") from None


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


# ---------------------------------------------------------------------------
# The oracle's fault models
# ---------------------------------------------------------------------------


class FaultModel:
    """Base: a healthy network."""

    def is_crashed(self, node: Endpoint, tick: int) -> bool:
        return False

    def edge_ok(self, src: Endpoint, dst: Endpoint, tick: int) -> bool:
        """Whether a message sent src -> dst delivered at ``tick``
        survives."""
        return True

    def delay_of(self, src: Endpoint, dst: Endpoint, tick: int) -> int:
        """Extra delivery delay in ticks of a message *sent* src -> dst at
        ``tick``, on top of the one-hop baseline."""
        return 0

    def crash_mask(self, endpoints: Sequence[Endpoint],
                   tick: int) -> np.ndarray:
        """bool[n]: True = crashed at tick."""
        if type(self).is_crashed is FaultModel.is_crashed:
            return np.zeros(len(endpoints), dtype=bool)
        return np.array([self.is_crashed(e, tick) for e in endpoints],
                        dtype=bool)

    def edge_mask(self, endpoints: Sequence[Endpoint],
                  tick: int) -> np.ndarray:
        """bool[n, n]: [s, d] True = deliverable src->dst at tick (crashes
        apart). The generic form calls ``edge_ok`` per pair; the models
        below override it with array forms."""
        n = len(endpoints)
        mask = np.ones((n, n), dtype=bool)
        if type(self).edge_ok is FaultModel.edge_ok:
            return mask
        for i, s in enumerate(endpoints):
            for j, d in enumerate(endpoints):
                if not self.edge_ok(s, d, tick):
                    mask[i, j] = False
        return mask


HEALTHY = FaultModel()


@dataclass
class CrashFault(FaultModel):
    """Nodes crash (fail-stop) at given ticks: {endpoint: crash_tick}."""

    crashes: Dict[Endpoint, int] = field(default_factory=dict)

    def is_crashed(self, node: Endpoint, tick: int) -> bool:
        t = self.crashes.get(node)
        return t is not None and tick >= t

    def crash_mask(self, endpoints, tick):
        ticks = np.array([self.crashes.get(e, np.iinfo(np.int64).max)
                          for e in endpoints])
        return ticks <= tick


@dataclass
class PacketDropFault(FaultModel):
    """Drop with probability ``p`` on edges into (``ingress``) or out of
    (``egress``) a target set, or everywhere without targets."""

    p: float = 0.0
    targets: Optional[FrozenSet[Endpoint]] = None
    ingress: bool = True
    egress: bool = True
    seed: int = 0

    def _applies(self, src: Endpoint, dst: Endpoint) -> bool:
        if self.targets is None:
            return True
        return (self.ingress and dst in self.targets) or \
               (self.egress and src in self.targets)

    def edge_ok(self, src: Endpoint, dst: Endpoint, tick: int) -> bool:
        if not self._applies(src, dst):
            return True
        return not _bernoulli(self.seed, uid_of(src), uid_of(dst), tick,
                              self.p)

    def edge_mask(self, endpoints, tick):
        uids = np.array([uid_of(e) for e in endpoints], dtype=np.uint64)
        drop = _bernoulli_matrix(self.seed, uids, tick, self.p)
        if self.targets is not None:
            t = np.array([e in self.targets for e in endpoints], dtype=bool)
            applies = np.zeros((len(endpoints), len(endpoints)), dtype=bool)
            if self.ingress:
                applies |= t[None, :]
            if self.egress:
                applies |= t[:, None]
            drop &= applies
        return ~drop


@dataclass
class OneWayPartitionFault(FaultModel):
    """Messages from ``from_set`` to ``to_set`` are dropped in
    ``[start_tick, end_tick)``, one direction only."""

    from_set: FrozenSet[Endpoint] = frozenset()
    to_set: FrozenSet[Endpoint] = frozenset()
    start_tick: int = 0
    end_tick: int = 1 << 62

    def edge_ok(self, src: Endpoint, dst: Endpoint, tick: int) -> bool:
        if not (self.start_tick <= tick < self.end_tick):
            return True
        return not (src in self.from_set and dst in self.to_set)

    def edge_mask(self, endpoints, tick):
        n = len(endpoints)
        if not (self.start_tick <= tick < self.end_tick):
            return np.ones((n, n), dtype=bool)
        f = np.array([e in self.from_set for e in endpoints], dtype=bool)
        t = np.array([e in self.to_set for e in endpoints], dtype=bool)
        return ~(f[:, None] & t[None, :])


@dataclass
class FlipFlopFault(FaultModel):
    """A target set is unreachable for ``period_ticks``, then reachable
    for ``period_ticks``, repeating from ``start_tick`` (off first);
    ``one_way`` drops only messages into the targets."""

    targets: FrozenSet[Endpoint] = frozenset()
    period_ticks: int = 200
    start_tick: int = 0
    one_way: bool = True

    def _off_phase(self, tick: int) -> bool:
        if tick < self.start_tick:
            return False
        return ((tick - self.start_tick) // self.period_ticks) % 2 == 0

    def edge_ok(self, src: Endpoint, dst: Endpoint, tick: int) -> bool:
        if not self._off_phase(tick):
            return True
        if dst in self.targets and src not in self.targets:
            return False
        if not self.one_way and src in self.targets and \
                dst not in self.targets:
            return False
        return True

    def edge_mask(self, endpoints, tick):
        n = len(endpoints)
        if not self._off_phase(tick):
            return np.ones((n, n), dtype=bool)
        t = np.array([e in self.targets for e in endpoints], dtype=bool)
        blocked = ~t[:, None] & t[None, :]
        if not self.one_way:
            blocked |= t[:, None] & ~t[None, :]
        return ~blocked


@dataclass
class ComposedFault(FaultModel):
    """Intersection of several fault models (all must allow delivery);
    delays add."""

    models: List[FaultModel] = field(default_factory=list)

    def is_crashed(self, node, tick):
        return any(m.is_crashed(node, tick) for m in self.models)

    def edge_ok(self, src, dst, tick):
        return all(m.edge_ok(src, dst, tick) for m in self.models)

    def delay_of(self, src, dst, tick):
        return sum(m.delay_of(src, dst, tick) for m in self.models)

    def crash_mask(self, endpoints, tick):
        mask = np.zeros(len(endpoints), dtype=bool)
        for m in self.models:
            mask |= m.crash_mask(endpoints, tick)
        return mask

    def edge_mask(self, endpoints, tick):
        mask = np.ones((len(endpoints), len(endpoints)), dtype=bool)
        for m in self.models:
            mask &= m.edge_mask(endpoints, tick)
        return mask


def correlated_rack_failure(endpoints: Sequence[Endpoint],
                            rack_of: Callable[[Endpoint], int],
                            failed_racks: Set[int],
                            crash_tick: int) -> CrashFault:
    """All nodes in the failed racks crash together at ``crash_tick``."""
    return CrashFault({e: crash_tick for e in endpoints
                       if rack_of(e) in failed_racks})


def _slot_of(endpoint: Endpoint) -> int:
    """The slot of an ``nX.sim`` endpoint (``engine.diff
    .default_endpoints``), -1 for any other."""
    host = endpoint.hostname
    return int(host[1:host.index(".")]) if host.startswith("n") else -1


class LinkWindowFault(FaultModel):
    """The oracle-side edge rule of slot-indexed ``LinkWindow``s, slots
    resolved by the ``nX.sim`` convention."""

    def __init__(self, windows: Sequence[LinkWindow]) -> None:
        self.windows = tuple(windows)

    _slot = staticmethod(_slot_of)

    def edge_ok(self, src: Endpoint, dst: Endpoint, tick: int) -> bool:
        s, d = self._slot(src), self._slot(dst)
        return not any(w.blocks(s, d, tick) for w in self.windows)

    def edge_mask(self, endpoints, tick):
        n = len(endpoints)
        mask = np.ones((n, n), dtype=bool)
        slots = np.array([self._slot(e) for e in endpoints])
        for w in self.windows:
            if not w.active(tick):
                continue
            s = np.isin(slots, list(w.src_slots))
            d = np.isin(slots, list(w.dst_slots))
            blocked = s[:, None] & d[None, :]
            if w.two_way:
                blocked |= d[:, None] & s[None, :]
            mask &= ~blocked
        return mask


class LinkDelayFault(FaultModel):
    """The oracle-side latency rule of slot-indexed ``DelayRule``s; it
    drops nothing."""

    def __init__(self, delays: Sequence[DelayRule], seed: int) -> None:
        self.delays = tuple(delays)
        self.seed = seed

    _slot = staticmethod(_slot_of)

    def delay_of(self, src: Endpoint, dst: Endpoint, tick: int) -> int:
        return delay_of_slots(self.delays, self.seed, self._slot(src),
                              self._slot(dst), tick)


def link_windows_of(model: FaultModel, endpoints: Sequence[Endpoint]
                    ) -> Optional[List[LinkWindow]]:
    """A model's link rules in ``LinkWindow`` normal form (slots follow
    ``endpoints`` order), or None when no window set reproduces them
    exactly (probabilistic drops)."""
    slot_of = {e: i for i, e in enumerate(endpoints)}

    def slots(es) -> FrozenSet[int]:
        return frozenset(slot_of[e] for e in es if e in slot_of)

    if isinstance(model, ComposedFault):
        out: List[LinkWindow] = []
        for m in model.models:
            sub = link_windows_of(m, endpoints)
            if sub is None:
                return None
            out += sub
        return out
    if isinstance(model, LinkWindowFault):
        return list(model.windows)
    if isinstance(model, OneWayPartitionFault):
        return [LinkWindow(src_slots=slots(model.from_set),
                           dst_slots=slots(model.to_set),
                           start_tick=model.start_tick,
                           end_tick=min(model.end_tick, NEVER_TICK))]
    if isinstance(model, FlipFlopFault):
        t = slots(model.targets)
        others = frozenset(range(len(endpoints))) - t
        return [LinkWindow(src_slots=others, dst_slots=t,
                           start_tick=model.start_tick,
                           period_ticks=model.period_ticks,
                           two_way=not model.one_way)]
    if isinstance(model, CrashFault) or type(model) is FaultModel:
        return []
    return None


# ---------------------------------------------------------------------------
# Seeded Bernoulli drops
# ---------------------------------------------------------------------------

_P_SCALE = float(1 << 32)


def _bernoulli(seed: int, src_uid: int, dst_uid: int, tick: int,
               p: float) -> bool:
    h = hashing.hash64(
        src_uid ^ hashing.hash64(dst_uid, seed=tick & hashing.MASK64),
        seed=seed ^ 0xD809F)
    return (h >> 32) < int(p * _P_SCALE)


def _bernoulli_matrix(seed: int, uids: np.ndarray, tick: int,
                      p: float) -> np.ndarray:
    """bool[n, n] of drop decisions; [s, d] is ``_bernoulli(s, d)``."""
    uids = uids.astype(np.uint64)
    th = hashing.hash64_np(uids, tick & hashing.MASK64)
    h = hashing.hash64_np(uids[:, None] ^ th[None, :], seed ^ 0xD809F)
    return (h >> np.uint64(32)) < np.uint64(int(p * _P_SCALE))
