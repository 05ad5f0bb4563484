"""The tick engines in PyTorch, with the CUDA delivery kernel.

Modules mirror the reference's layout: ``state`` (the carries, logs and
faults), ``topology``, ``paxos`` (the classic-Paxos fallback and its host
planner), ``churn`` (join/leave schedules, identifier redraws and the host
planner ``plan_churn``), ``monitor``, ``cut``, ``votes``, ``invariants``
(the invariant monitor), ``recorder`` (the flight recorder), ``step``
(the shared-state engine, with the ``variants`` ring and hier),
``diff`` (the differential runners against the host referee, and the
shared engine's host-side events and counters), ``adversary`` (the host
adversary engine, the per-receiver engine's referee),
``rx_account`` (the delivery kernels and their plain versions), ``receiver`` (the
per-receiver step, boot, lowering and host extractors), ``rx_packed``
(the packed carry and its tick loop) and ``sharding`` (slot and fleet
meshes).

The shared engine's entry points are exported here::

    state = init_state(uids, id_fp_sum, Settings())
    final, logs = simulate(state, crash_faults(ticks), n_ticks, Settings())
    # with churn or scripted contested instances (host schedules moved
    # to the device by convert.from_reference):
    final, logs = simulate(state, faults, n_ticks, Settings(),
                           churn=churn_schedule, fallback=fallback_schedule)
    # a schedule planned by the join protocol:
    plan = plan_churn(endpoints, n, node_ids, n_ticks, Settings(),
                      joins={slot: tick}, leaves={slot: tick})
    # the monitor and the recorder:
    final, logs, rec = simulate(state, faults, n_ticks, Settings(
        invariant_checks=True, flight_recorder_window=64))
    check_run(logs)
"""
from rapid_tpu_torch.engine.churn import (
    ChurnEnvelopeError, ChurnPlan, ChurnSchedule, plan_churn,
    synthetic_churn_schedule)
from rapid_tpu_torch.engine.diff import (
    ViewEvent, engine_events, expand_counters, expand_fallback_counters)
from rapid_tpu_torch.engine.paxos import (
    FallbackEnvelopeError, FallbackSchedule, plan_fallback,
    synthetic_contested_schedule)
from rapid_tpu_torch.engine.state import (
    EngineFaults, EngineState, StepLog, crash_faults, init_state,
    link_faults, state_config_id)
from rapid_tpu_torch.engine.invariants import (
    InvariantViolationError, check_run)
from rapid_tpu_torch.engine.sharding import slot_mesh
from rapid_tpu_torch.engine.step import simulate, simulate_chunk

__all__ = ["ChurnEnvelopeError", "ChurnPlan", "ChurnSchedule",
           "EngineFaults", "EngineState", "FallbackEnvelopeError",
           "FallbackSchedule", "InvariantViolationError", "StepLog",
           "ViewEvent", "check_run", "crash_faults", "engine_events",
           "expand_counters", "expand_fallback_counters", "init_state",
           "link_faults", "plan_churn", "plan_fallback", "simulate",
           "simulate_chunk", "slot_mesh", "state_config_id",
           "synthetic_churn_schedule", "synthetic_contested_schedule"]
