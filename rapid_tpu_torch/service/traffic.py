"""Open-loop traffic generator: seeded arrival processes -> ChurnSchedule.

The port's own copy of the reference's generator (host numpy and the
port's ``hashing``; it draws the same PCG64 stream, so the two emit the
same schedules chunk for chunk). The schedules are host numpy
``ChurnSchedule``s; the resident engine moves each to its device.

The resident engine (``service.resident``) consumes membership traffic
chunk by chunk; this module generates it the way a live deployment
would see it — *open loop*, arrivals keep coming whether or not the
protocol has caught up:

- **Poisson joins** — per-tick arrivals drawn ``Poisson(lambda_t)``,
  ``lambda_t = join_rate_per_ktick / 1000`` nodes/tick;
- **correlated leave bursts** — at exponentially-distributed instants a
  *contiguous block* of current members departs together (a rack/zone
  going away, not independent attrition; under the ``two_zone`` slot
  split of ``faults.two_zone_schedule`` a block is one zone's slice);
- **diurnal waves** — ``lambda_t`` modulated by
  ``1 + amplitude * sin(2*pi*t / period)``, so soak runs sweep through
  load peaks and troughs instead of a flat rate.

Arrivals accumulate into *bursts* lowered onto the existing
``ChurnSchedule`` enqueue-tick encoding (``engine.churn``), under the
same envelope ``synthetic_churn_schedule`` obeys: one alert pipeline in
flight (bursts spaced ``>= churn_decide_delay_ticks + 1`` ticks, default
``+ 3``), each burst homogeneous (all-joins or all-leaves) with its
epoch expectation equal to the count of previously decided bursts, and
dormant identifier fingerprints drawn from the same
``hash64(slot, seed=0x6964)`` stream. Because the encoding and epoch
accounting are exactly the planner's, a generated horizon can be
replayed through the host oracle referee: :meth:`TrafficGenerator
.churn_calls` rewrites enqueue ticks back to ``Cluster.join()`` /
``leave_gracefully()`` call ticks for ``engine.churn.plan_churn`` /
``diff.run_churn_differential`` (run with ``reuse_slots=False`` — the
oracle remembers identifiers forever, so slot recycling is an
engine-only economy for unbounded soaks).

Determinism: one ``numpy`` PCG64 stream, advanced strictly per tick, so
the chunk split never changes the traffic — 10 chunks of 100 ticks draw
the identical event sequence as 1 chunk of 1000. The full generator
state (rng snapshot included) round-trips through
:meth:`TrafficGenerator.state_dict` for the checkpoint ``host`` blob.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from rapid_tpu_torch import hashing
from rapid_tpu_torch.engine.churn import empty_schedule
from rapid_tpu_torch.engine.state import I32_MAX
from rapid_tpu_torch.settings import Settings

#: Seed namespace for dormant-slot identifier fingerprints — must match
#: ``engine.churn.synthetic_churn_schedule`` so generated joiners carry
#: the same identities the engine-side boot expects.
ID_FP_SEED = 0x6964


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Knobs for one seeded arrival process (all rates in events per
    1000 ticks of virtual time; the bench reports the wall-clock
    events/sec this sustains)."""

    seed: int = 0
    #: Mean Poisson join arrivals per 1000 ticks.
    join_rate_per_ktick: float = 20.0
    #: Mean correlated leave *bursts* per 1000 ticks (exponential
    #: inter-arrival), each removing ``leave_burst_size`` members.
    leave_burst_rate_per_ktick: float = 2.0
    leave_burst_size: int = 4
    #: Diurnal modulation of the join rate: 0 = flat, 0.8 = swings
    #: between 0.2x and 1.8x the base rate over ``diurnal_period_ticks``.
    diurnal_amplitude: float = 0.0
    diurnal_period_ticks: int = 2000
    #: Minimum ticks between burst enqueues; 0 derives the same
    #: ``churn_decide_delay_ticks + 3`` spacing
    #: ``synthetic_churn_schedule`` uses.
    burst_spacing_ticks: int = 0
    #: Cap on joins lowered into one burst (excess stays queued —
    #: open-loop backpressure, never dropped).
    max_join_burst: int = 8
    #: Leave bursts never shrink membership below this floor.
    min_members: int = 8
    #: Recycle slots whose members left (engine-only semantics; disable
    #: for oracle-refereed replays, where identifiers live forever). A
    #: freed slot cools down for ``max(burst spacing,
    #: Settings.stream_chunk_ticks)`` ticks before it may rejoin — the
    #: delay depends only on when the slot left, never on where a chunk
    #: boundary fell, so recycling preserves chunk-split invariance.
    reuse_slots: bool = True
    #: Closed-loop sampling (``service.servo``): joins draw exactly one
    #: uniform per tick and invert the Poisson CDF, so the rng stream
    #: advances identically whatever the current rate — the servo may
    #: retarget ``set_join_rate`` between chunks without perturbing the
    #: seeded stream, and a recorded rate trace replays byte-exactly.
    #: False keeps the historical ``rng.poisson`` draw (whose stream
    #: consumption is rate-dependent) and rejects ``set_join_rate``.
    closed_loop: bool = False

    def __post_init__(self) -> None:
        if self.join_rate_per_ktick < 0 or self.leave_burst_rate_per_ktick < 0:
            raise ValueError("traffic rates must be >= 0")
        if not (0.0 <= self.diurnal_amplitude <= 1.0):
            raise ValueError(
                f"diurnal_amplitude must be in [0, 1], got "
                f"{self.diurnal_amplitude}")
        if self.diurnal_period_ticks < 1:
            raise ValueError("diurnal_period_ticks must be >= 1")
        if self.leave_burst_size < 1 or self.max_join_burst < 1:
            raise ValueError("burst sizes must be >= 1")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _poisson_inverse(u: float, lam: float) -> int:
    """Poisson sample by CDF inversion from one uniform draw —
    deterministic in ``(u, lam)`` and rate-independent in rng
    consumption. Per-tick lambdas here are O(1) (at most
    ``max_rate_per_ktick / 1000`` per tick times the diurnal swing), so
    the walk terminates in a handful of steps; the hard cap guards a
    pathological hand-built config."""
    if lam <= 0.0:
        return 0
    p = math.exp(-lam)
    cum = p
    k = 0
    while u > cum and k < 4096:
        k += 1
        p *= lam / k
        cum += p
    return k


class TrafficGenerator:
    """Stateful chunk-by-chunk lowering of one arrival process.

    ``capacity`` slots total; ``[0, n_initial)`` boot as members, the
    rest are the dormant joiner pool. Call :meth:`next_chunk` with
    consecutive tick windows; each returns a ``ChurnSchedule`` covering
    exactly that window (or None when no event falls inside it).
    """

    def __init__(self, config: TrafficConfig, settings: Settings,
                 capacity: int, n_initial: int, start_tick: int = 0,
                 start_epoch: int = 0):
        if n_initial >= capacity:
            raise ValueError(
                f"capacity ({capacity}) must exceed n_initial "
                f"({n_initial}) to leave a joiner pool")
        self.config = config
        self.capacity = int(capacity)
        self.n_initial = int(n_initial)
        spacing = config.burst_spacing_ticks
        if spacing == 0:
            spacing = settings.churn_decide_delay_ticks + 3
        if spacing <= settings.churn_decide_delay_ticks:
            raise ValueError(
                f"burst_spacing_ticks ({spacing}) must exceed the "
                f"enqueue->decide delay "
                f"({settings.churn_decide_delay_ticks}) so at most one "
                f"alert pipeline is in flight")
        self._spacing = int(spacing)
        self._decide_delay = int(settings.churn_decide_delay_ticks)
        # Slot-recycle eligibility is *history-only* (freed at tick t ->
        # re-join-eligible at t + recycle), never per-chunk bookkeeping:
        # chunk-split invariance demands that whether a slot can rejoin
        # depends on when it left, not on where a chunk boundary fell.
        # recycle >= stream_chunk_ticks also guarantees a slot appears
        # at most once per field in any schedule covering a window of
        # up to stream_chunk_ticks — the ChurnSchedule encoding's limit.
        self._recycle = max(self._spacing,
                            int(settings.stream_chunk_ticks))
        self._rng = np.random.Generator(np.random.PCG64(config.seed))
        # The live join rate: config.join_rate_per_ktick until a servo
        # retargets it (closed_loop only — see set_join_rate).
        self._rate_per_ktick = float(config.join_rate_per_ktick)
        self._members = sorted(range(n_initial))
        # FIFO of [slot, eligible_tick]; the boot pool is eligible
        # immediately.
        self._free = [[s, 0] for s in range(n_initial, capacity)]
        self._epoch = int(start_epoch)
        self._tick = int(start_tick)
        # First burst lands one full spacing in, so rewriting enqueue
        # ticks back to Cluster-call ticks (``churn_calls``) never goes
        # below tick 1.
        self._next_enqueue = int(start_tick) + self._spacing
        self._pending_joins = 0
        self._pending_leaves = 0
        self.events = 0
        self.joins = 0
        self.leaves = 0
        self.bursts = 0
        self._calls: list = []   # (kind, enqueue_tick, slots) history

    # --- boot-side helpers ------------------------------------------------

    def boot_id_fps(self) -> np.ndarray:
        """Identifier fingerprints for every dormant slot (the
        ``init_state(id_fps=...)`` argument), same stream as
        ``synthetic_churn_schedule``."""
        id_fps = np.zeros(self.capacity, np.uint64)
        for s in range(self.n_initial, self.capacity):
            id_fps[s] = np.uint64(hashing.hash64(s, seed=ID_FP_SEED))
        return id_fps

    @property
    def n_members(self) -> int:
        return len(self._members)

    # --- the arrival process ---------------------------------------------

    def set_join_rate(self, rate_per_ktick: float) -> None:
        """Retarget the join rate (events per kilotick) — the servo's
        actuator. Only legal on closed-loop generators, where the rng
        advancement is rate-independent; changing the Poisson lambda of
        the open-loop ``rng.poisson`` draw would silently shift the
        seeded stream."""
        if not self.config.closed_loop:
            raise ValueError(
                "set_join_rate requires TrafficConfig.closed_loop=True "
                "(open-loop rng advancement is rate-dependent)")
        if rate_per_ktick < 0:
            raise ValueError(
                f"rate_per_ktick must be >= 0, got {rate_per_ktick}")
        self._rate_per_ktick = float(rate_per_ktick)

    def _join_rate(self, t: int) -> float:
        base = self._rate_per_ktick / 1000.0
        amp = self.config.diurnal_amplitude
        if amp == 0.0:
            return base
        return base * (1.0 + amp * math.sin(
            2.0 * math.pi * t / self.config.diurnal_period_ticks))

    def _emit_leave_burst(self, t: int, chunk_bursts: list) -> None:
        floor = self.config.min_members
        take = min(self._pending_leaves, max(0, len(self._members) - floor))
        if take <= 0:
            self._pending_leaves = 0
            return
        # Correlated departure: a contiguous block of the live slot
        # order leaves together.
        start = int(self._rng.integers(0, len(self._members)))
        slots = [self._members[(start + i) % len(self._members)]
                 for i in range(take)]
        for s in slots:
            self._members.remove(s)
            if self.config.reuse_slots:
                self._free.append([s, t + self._recycle])
        self._pending_leaves -= len(slots)
        chunk_bursts.append(("leave", t, self._epoch, sorted(slots)))
        self._calls.append(("leave", t, tuple(sorted(slots))))
        self._epoch += 1
        self.leaves += len(slots)
        self.events += len(slots)
        self.bursts += 1
        self._next_enqueue = t + self._spacing

    def _emit_join_burst(self, t: int, chunk_bursts: list) -> None:
        want = min(self._pending_joins, self.config.max_join_burst)
        slots = []
        kept = []
        while self._free and len(slots) < want:
            entry = self._free.pop(0)
            s, eligible = entry
            # Slots still cooling down stay queued in FIFO order.
            if eligible > t:
                kept.append(entry)
            else:
                slots.append(s)
        self._free = kept + self._free
        if not slots:
            return
        for s in slots:
            self._members.append(s)
        self._members.sort()
        self._pending_joins -= len(slots)
        chunk_bursts.append(("join", t, self._epoch, sorted(slots)))
        self._calls.append(("join", t, tuple(sorted(slots))))
        self._epoch += 1
        self.joins += len(slots)
        self.events += len(slots)
        self.bursts += 1
        self._next_enqueue = t + self._spacing

    def next_chunk(self, n_ticks: int) -> tuple:
        """Advance the process over the next ``n_ticks`` ticks; returns
        ``(schedule, info)`` where ``schedule`` is a ``ChurnSchedule``
        whose enqueue ticks all fall in ``(tick, tick + n_ticks]`` (None
        when the window is quiet) and ``info`` counts what was lowered.
        """
        leave_per_tick = self.config.leave_burst_rate_per_ktick / 1000.0
        chunk_bursts: list = []
        t0 = self._tick
        closed = self.config.closed_loop
        for t in range(t0 + 1, t0 + int(n_ticks) + 1):
            if closed:
                self._pending_joins += _poisson_inverse(
                    self._rng.random(), self._join_rate(t))
            else:
                self._pending_joins += int(
                    self._rng.poisson(self._join_rate(t)))
            if self._rng.random() < leave_per_tick:
                self._pending_leaves += self.config.leave_burst_size
            if t < self._next_enqueue:
                continue
            if self._pending_leaves > 0:
                self._emit_leave_burst(t, chunk_bursts)
            elif self._pending_joins > 0:
                self._emit_join_burst(t, chunk_bursts)
        self._tick = t0 + int(n_ticks)
        info = {
            "bursts": len(chunk_bursts),
            "joins": sum(len(b[3]) for b in chunk_bursts if b[0] == "join"),
            "leaves": sum(len(b[3]) for b in chunk_bursts if b[0] == "leave"),
            "backlog_joins": self._pending_joins,
            "backlog_leaves": self._pending_leaves,
            "n_members": len(self._members),
        }
        info["events"] = info["joins"] + info["leaves"]
        if not chunk_bursts:
            return None, info
        schedule = empty_schedule(self.capacity)
        for kind, t, epoch, slots in chunk_bursts:
            for s in slots:
                field = (schedule.join_tick if kind == "join"
                         else schedule.leave_tick)
                if field[s] != I32_MAX:
                    # Structurally impossible for windows within the
                    # slot-recycle delay; an oversized manual window can
                    # revisit a slot, which the per-slot enqueue-tick
                    # encoding cannot express.
                    raise ValueError(
                        f"chunk window of {n_ticks} ticks revisits slot "
                        f"{s} ({kind}); windows must not exceed the "
                        f"slot-recycle delay ({self._recycle} ticks)")
                if kind == "join":
                    schedule.join_tick[s] = t
                    schedule.join_epoch[s] = epoch
                else:
                    schedule.leave_tick[s] = t
                    schedule.leave_epoch[s] = epoch
        return schedule, info

    # --- oracle-referee bridge -------------------------------------------

    def churn_calls(self, settings: Settings) -> tuple:
        """The generated history as ``Cluster`` call ticks —
        ``(joins, leaves)`` dicts of ``slot -> call tick`` in
        ``plan_churn`` / ``diff.run_churn_differential`` form (enqueue
        minus the join/leave RPC pipeline delays). Only meaningful with
        ``reuse_slots=False``: the oracle remembers identifiers forever.
        """
        if self.config.reuse_slots:
            raise ValueError(
                "churn_calls requires reuse_slots=False (the oracle "
                "referee never recycles identifiers)")
        joins: dict = {}
        leaves: dict = {}
        for kind, t, slots in self._calls:
            if kind == "join":
                for s in slots:
                    joins[s] = t - settings.join_enqueue_delay_ticks
            else:
                for s in slots:
                    leaves[s] = t - settings.leave_enqueue_delay_ticks
        return joins, leaves

    # --- checkpoint host blob --------------------------------------------

    def state_dict(self) -> dict:
        """JSON-serializable snapshot (rng stream included) for the
        checkpoint ``host`` blob; exact resume via :meth:`from_state`."""
        rng_state = self._rng.bit_generator.state
        return {
            "kind": "traffic_generator",
            "config": self.config.as_dict(),
            "capacity": self.capacity,
            "n_initial": self.n_initial,
            "rng": {"state": int(rng_state["state"]["state"]),
                    "inc": int(rng_state["state"]["inc"]),
                    "has_uint32": int(rng_state["has_uint32"]),
                    "uinteger": int(rng_state["uinteger"])},
            "rate_per_ktick": self._rate_per_ktick,
            "members": list(self._members),
            "free": [[int(s), int(e)] for s, e in self._free],
            "epoch": self._epoch,
            "tick": self._tick,
            "next_enqueue": self._next_enqueue,
            "pending_joins": self._pending_joins,
            "pending_leaves": self._pending_leaves,
            "events": self.events,
            "joins": self.joins,
            "leaves": self.leaves,
            "bursts": self.bursts,
        }

    @classmethod
    def from_state(cls, state: dict, settings: Settings
                   ) -> "TrafficGenerator":
        config = TrafficConfig(**state["config"])
        gen = cls(config, settings, state["capacity"], state["n_initial"])
        gen._rng.bit_generator.state = {
            "bit_generator": "PCG64",
            "state": {"state": state["rng"]["state"],
                      "inc": state["rng"]["inc"]},
            "has_uint32": state["rng"]["has_uint32"],
            "uinteger": state["rng"]["uinteger"],
        }
        gen._rate_per_ktick = float(
            state.get("rate_per_ktick", config.join_rate_per_ktick))
        gen._members = list(state["members"])
        gen._free = [[int(s), int(e)] for s, e in state["free"]]
        gen._epoch = int(state["epoch"])
        gen._tick = int(state["tick"])
        gen._next_enqueue = int(state["next_enqueue"])
        gen._pending_joins = int(state["pending_joins"])
        gen._pending_leaves = int(state["pending_leaves"])
        gen.events = int(state["events"])
        gen.joins = int(state["joins"])
        gen.leaves = int(state["leaves"])
        gen.bursts = int(state["bursts"])
        return gen
