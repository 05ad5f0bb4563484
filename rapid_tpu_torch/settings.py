"""Configuration, field for field the reference ``rapid_tpu.settings``.

One tick is the reference's 100 ms alert batching window, so reference
timers map to tick counts:

- batching window 100 ms        -> 1 tick
- failure-detector interval 1 s -> ``fd_interval_ticks`` = 10
- consensus fallback base 1 s   -> ``fallback_base_delay_ticks`` = 10 plus an
  expovariate jitter with rate 1/N ticks
- message latency: a message sent in tick t is delivered in tick t+1.

The port keeps its own copy (it imports nothing of ``rapid_tpu``); the
fields, defaults and validation are the reference's, so a ``Settings`` of
either package describes the same run.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class Settings:
    # --- overlay / cut detection ---
    K: int = 10
    H: int = 9
    L: int = 4

    # --- time model (see module docstring) ---
    tick_ms: int = 100
    batching_window_ticks: int = 1
    fd_interval_ticks: int = 10
    fallback_base_delay_ticks: int = 10

    # --- failure detector ---
    fd_failure_threshold: int = 10
    fd_bootstrap_tolerance: int = 30

    # --- join protocol ---
    join_attempts: int = 5
    join_timeout_ticks: int = 50

    # --- leave ---
    leave_timeout_ticks: int = 15

    # --- engine capacity / scale knobs ---
    capacity: int = 0           # 0 = derive from initial membership + joiners
    max_configs: int = 4
    max_proposals: int = 4
    max_cut_size: int = 64
    max_active_dsts: int = 128

    # --- per-receiver link-fault mode (engine.receiver) ---
    # Hard cap on the slot capacity a per-receiver member may boot with
    # (the state is quadratic per member).
    receiver_capacity_cap: int = 4096

    # Receiver scan-carry layout and delivery kernel. The port runs
    # "pallas" only: the packed carry plus the hand-written delivery
    # kernel (``engine.rx_account``). "xla" and "packed" are accepted
    # here, as in the reference, and refused by the engine entry points.
    rx_kernel: str = "xla"

    # Dissemination/consensus protocol variant ("rapid", "ring", "hier").
    protocol_variant: str = "rapid"

    # Width of the packed per-slot epoch deltas (8 or 16); a delta that
    # does not fit is clamped AND flagged (receiver.FLAG_EPOCH_DELTA_SAT).
    rx_epoch_delta_bits: int = 8

    # Depth D of the per-receiver in-flight delivery ring: the largest
    # extra link delay a schedule may draw is D - 1.
    delivery_ring_depth: int = 4

    # --- observability ---
    invariant_checks: bool = False
    flight_recorder_window: int = 0

    # --- streaming service ---
    stream_chunk_ticks: int = 256

    # --- randomness ---
    seed: int = 0

    def __post_init__(self) -> None:
        if not (self.K >= 3 and self.K >= self.H >= self.L > 0):
            raise ValueError(
                f"Arguments do not satisfy K >= H >= L > 0, K >= 3: "
                f"(K: {self.K}, H: {self.H}, L: {self.L})"
            )
        if self.delivery_ring_depth < 1:
            raise ValueError(
                f"delivery_ring_depth must be >= 1, got "
                f"{self.delivery_ring_depth}")
        if self.flight_recorder_window < 0:
            raise ValueError(
                f"flight_recorder_window must be >= 0, got "
                f"{self.flight_recorder_window}")
        if self.rx_kernel not in ("xla", "packed", "pallas"):
            raise ValueError(
                f"rx_kernel must be one of 'xla', 'packed', 'pallas', "
                f"got {self.rx_kernel!r}")
        if self.protocol_variant not in ("rapid", "ring", "hier"):
            raise ValueError(
                f"protocol_variant must be one of 'rapid', 'ring', "
                f"'hier', got {self.protocol_variant!r}")
        if self.stream_chunk_ticks < 1:
            raise ValueError(
                f"stream_chunk_ticks must be >= 1, got "
                f"{self.stream_chunk_ticks}")
        if self.rx_epoch_delta_bits not in (8, 16):
            raise ValueError(
                f"rx_epoch_delta_bits must be 8 or 16, got "
                f"{self.rx_epoch_delta_bits}")

    def with_(self, **kw) -> "Settings":
        return replace(self, **kw)

    # --- derived churn-pipeline delays ----------------------------------

    @property
    def join_enqueue_delay_ticks(self) -> int:
        return 3

    @property
    def leave_enqueue_delay_ticks(self) -> int:
        return 1

    @property
    def churn_announce_delay_ticks(self) -> int:
        return self.batching_window_ticks + 1

    @property
    def churn_decide_delay_ticks(self) -> int:
        return self.churn_announce_delay_ticks + 1


DEFAULT_SETTINGS = Settings()
