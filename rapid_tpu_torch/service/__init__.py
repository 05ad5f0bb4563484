"""Streaming service mode: the engine as a long-lived membership process.

The port of the reference's ``service`` package, six pieces:

- ``resident`` — the chunked service loop around
  ``engine.step.simulate_chunk`` (chunk k dispatched before chunk k-1 is
  drained), streaming ``TickMetrics`` JSONL;
- ``rx_resident`` — the per-receiver twin around
  ``engine.receiver.receiver_simulate_chunk`` (layout-preserving: dense
  or packed carry), with the same heartbeats and checkpoint proof;
- ``checkpoint`` — versioned save/restore of every scan carry family
  (engine, dense receiver, packed receiver, recorder ring), proven
  bit-identical across the save/load boundary;
- ``traffic`` — the seeded arrival processes (Poisson joins, correlated
  leave bursts, diurnal waves) lowered chunk-by-chunk onto
  ``ChurnSchedule``; ``closed_loop=True`` samples joins by CDF
  inversion from one uniform per tick, so rate changes never shift the
  seeded stream;
- ``servo`` — the deterministic target-rate load servo (events/sec ->
  quantized events/ktick from committed heartbeat walls);
- ``status`` — the read-only live status API (atomic status file +
  unix-socket line protocol with ``watch`` subscriptions).

``python -m rapid_tpu_torch.service --soak`` runs the long-haul gate;
``--load-sweep`` drives the saturation sweep that locates the knee;
``--rx-soak`` runs the packed receiver-resident soak.
"""
from rapid_tpu_torch.service.checkpoint import (
    CHECKPOINT_VERSION,
    Checkpoint,
    CheckpointCompatError,
    CheckpointError,
    CheckpointVersionError,
    load_checkpoint,
    restore_receiver_carry,
    save_checkpoint,
    save_engine,
    save_receiver,
)
from rapid_tpu_torch.service.resident import (ResidentEngine, boot_resident,
                                              synthetic_uids)
from rapid_tpu_torch.service.rx_resident import (ResidentReceiver,
                                           boot_resident_receiver)
from rapid_tpu_torch.service.servo import LoadServo, ServoConfig
from rapid_tpu_torch.service.status import (StatusFile, StatusPublisher,
                                      StatusSocket, read_status)
from rapid_tpu_torch.service.traffic import TrafficConfig, TrafficGenerator

__all__ = [
    "CHECKPOINT_VERSION",
    "Checkpoint",
    "CheckpointCompatError",
    "CheckpointError",
    "CheckpointVersionError",
    "LoadServo",
    "ResidentEngine",
    "ResidentReceiver",
    "ServoConfig",
    "StatusFile",
    "StatusPublisher",
    "StatusSocket",
    "TrafficConfig",
    "TrafficGenerator",
    "boot_resident",
    "boot_resident_receiver",
    "load_checkpoint",
    "read_status",
    "restore_receiver_carry",
    "save_checkpoint",
    "save_engine",
    "save_receiver",
    "synthetic_uids",
]
