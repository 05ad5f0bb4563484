"""The tick engines in PyTorch, with the CUDA delivery kernel.

Modules mirror the reference's layout: ``state`` (the carries, logs and
faults), ``topology``, ``paxos`` (the classic-Paxos fallback and its host
planner), ``churn`` (join/leave schedules and identifier redraws),
``monitor``, ``cut``, ``votes``, ``step`` (the shared-state engine),
``diff`` (host-side events and counters of the shared engine),
``rx_account`` (the kernel and its plain version), ``receiver`` (the
per-receiver step, boot, lowering and host extractors) and ``rx_packed``
(the packed carry and its tick loop).

The shared engine's entry points are exported here::

    state = init_state(uids, id_fp_sum, Settings())
    final, logs = simulate(state, crash_faults(ticks), n_ticks, Settings())
    # with churn or scripted contested instances (host schedules moved
    # to the device by convert.from_reference):
    final, logs = simulate(state, faults, n_ticks, Settings(),
                           churn=churn_schedule, fallback=fallback_schedule)
"""
from rapid_tpu_torch.engine.churn import (
    ChurnSchedule, synthetic_churn_schedule)
from rapid_tpu_torch.engine.diff import (
    ViewEvent, engine_events, expand_counters, expand_fallback_counters)
from rapid_tpu_torch.engine.paxos import (
    FallbackEnvelopeError, FallbackSchedule, plan_fallback,
    synthetic_contested_schedule)
from rapid_tpu_torch.engine.state import (
    EngineFaults, EngineState, StepLog, crash_faults, init_state,
    link_faults, state_config_id)
from rapid_tpu_torch.engine.step import simulate

__all__ = ["ChurnSchedule", "EngineFaults", "EngineState",
           "FallbackEnvelopeError", "FallbackSchedule", "StepLog",
           "ViewEvent", "crash_faults", "engine_events", "expand_counters",
           "expand_fallback_counters", "init_state", "link_faults",
           "plan_fallback", "simulate", "state_config_id",
           "synthetic_churn_schedule", "synthetic_contested_schedule"]
