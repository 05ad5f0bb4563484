"""Target-rate load servo: drive the traffic generator in events/sec.

The port's own copy of the reference's servo (pure host arithmetic).

The open-loop generator (``service.traffic``) is parameterized in
events per *kilotick of virtual time*; what the ROADMAP gate asks for
is a requested rate in events per *wall second*. The two are linked by
the measured chunk throughput: at ``tps`` ticks/sec, hitting
``target`` events/sec needs ``1000 * target / tps`` events per
kilotick. This module closes that loop deterministically:

- the control law runs only on **committed** observations — each chunk
  heartbeat's compile-excluded wall — and both the throughput estimate
  and the output rate are **quantized** to fixed grids
  (``tps_quantum``, ``rate_quantum_per_ktick``), so the applied-rate
  trace recorded in the heartbeats is exactly reproducible: replaying
  it (or pinning the throughput model) regenerates a byte-identical
  event schedule;
- rng-stream advancement is rate-independent: closed-loop generators
  draw exactly one uniform per tick for joins
  (``TrafficConfig.closed_loop`` — Poisson by CDF inversion), so a
  rate adjustment never shifts the seeded stream and the achieved
  trace still replays exactly through the host oracle referee;
- **backlog is the saturation observable**: the servo never chases the
  generator's offered-minus-applied backlog, it only reports it. Below
  the knee the backlog stays bounded; past the knee the requested
  per-ktick rate exceeds what burst admission can lower and the
  backlog grows without bound — which is precisely what the load sweep
  classifies as unstable;
- ``pinned_ticks_per_sec`` freezes the throughput model, making the
  whole closed loop a pure function of the seed and the target — the
  chunk-split-invariance and forced-saturation tests run in this mode,
  and so does any cross-machine replay of a committed sweep.

Walls below ``campaign.MIN_MEASURABLE_WALL_S`` are skipped (the same
null-rate convention every heartbeat uses): a sub-millisecond chunk
wall is timer noise, not a throughput observation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from rapid_tpu_torch.campaign import MIN_MEASURABLE_WALL_S


@dataclasses.dataclass(frozen=True)
class ServoConfig:
    """One closed-loop rate target plus the control-law constants
    (``telemetry.schema.SERVO_CONFIG_SPEC``)."""

    #: Requested wall-clock event rate the servo steers toward.
    target_events_per_sec: float
    #: Throughput prior used until the first committed observation.
    initial_ticks_per_sec: float = 1000.0
    #: Freeze the throughput model (tests, replays): the control law
    #: becomes a pure function of seed + target.
    pinned_ticks_per_sec: Optional[float] = None
    #: EWMA weight of the newest committed throughput observation.
    gain: float = 0.5
    #: Output rate grid (events per kilotick); committed rates land
    #: exactly on multiples of this quantum.
    rate_quantum_per_ktick: float = 0.25
    min_rate_per_ktick: float = 0.0
    max_rate_per_ktick: float = 1024.0
    #: Committed walls quantize to this ticks/sec grid before entering
    #: the estimate, so the recorded trace fully determines the law.
    tps_quantum: float = 1.0

    def __post_init__(self) -> None:
        if self.target_events_per_sec <= 0:
            raise ValueError("target_events_per_sec must be > 0")
        if not (0.0 < self.gain <= 1.0):
            raise ValueError(f"gain must be in (0, 1], got {self.gain}")
        if self.rate_quantum_per_ktick <= 0 or self.tps_quantum <= 0:
            raise ValueError("quantization steps must be > 0")
        if self.min_rate_per_ktick < 0 \
                or self.max_rate_per_ktick <= self.min_rate_per_ktick:
            raise ValueError("need 0 <= min_rate < max_rate")
        for f in ("initial_ticks_per_sec", "pinned_ticks_per_sec"):
            v = getattr(self, f)
            if v is not None and v <= 0:
                raise ValueError(f"{f} must be > 0, got {v}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _quantize(value: float, quantum: float) -> float:
    return round(value / quantum) * quantum


class LoadServo:
    """The committed control loop: ``observe`` one chunk's heartbeat
    wall, read the next chunk's ``rate_per_ktick``."""

    def __init__(self, config: ServoConfig):
        self.config = config
        pinned = config.pinned_ticks_per_sec
        self._tps = _quantize(
            config.initial_ticks_per_sec if pinned is None else pinned,
            config.tps_quantum)
        self._rate = self._rate_for(self._tps)
        self.updates = 0
        self.backlog = 0

    def _rate_for(self, tps: float) -> float:
        want = 1000.0 * self.config.target_events_per_sec / max(tps, 1e-9)
        want = _quantize(want, self.config.rate_quantum_per_ktick)
        return min(max(want, self.config.min_rate_per_ktick),
                   self.config.max_rate_per_ktick)

    @property
    def rate_per_ktick(self) -> float:
        """The committed rate for the next chunk (quantized)."""
        return self._rate

    @property
    def ticks_per_sec_estimate(self) -> float:
        return self._tps

    def observe(self, *, ticks: int, wall_s: float, backlog: int) -> None:
        """Commit one drained chunk: its compile-excluded wall updates
        the throughput estimate (unless pinned), the new rate derives
        from the updated estimate, and the offered-minus-applied
        backlog is recorded as the saturation observable."""
        self.backlog = int(backlog)
        if self.config.pinned_ticks_per_sec is not None:
            return
        if wall_s < MIN_MEASURABLE_WALL_S:
            return
        measured = _quantize(ticks / wall_s, self.config.tps_quantum)
        gain = self.config.gain
        self._tps = _quantize(gain * measured + (1.0 - gain) * self._tps,
                              self.config.tps_quantum)
        self._rate = self._rate_for(self._tps)
        self.updates += 1

    def chunk_block(self, applied_rate: float) -> dict:
        """The heartbeat ``servo`` block for a chunk that ran at
        ``applied_rate`` (``telemetry.schema.SERVO_CHUNK_SPEC``)."""
        return {
            "target_events_per_sec": self.config.target_events_per_sec,
            "rate_per_ktick": applied_rate,
            "ticks_per_sec_estimate": self._tps,
            "backlog": self.backlog,
            "updates": self.updates,
        }

    # --- checkpoint host blob --------------------------------------------

    def state_dict(self) -> dict:
        return {"kind": "load_servo",
                "config": self.config.as_dict(),
                "tps": self._tps,
                "rate": self._rate,
                "updates": self.updates,
                "backlog": self.backlog}

    @classmethod
    def from_state(cls, state: dict) -> "LoadServo":
        servo = cls(ServoConfig(**state["config"]))
        servo._tps = float(state["tps"])
        servo._rate = float(state["rate"])
        servo.updates = int(state["updates"])
        servo.backlog = int(state["backlog"])
        return servo
