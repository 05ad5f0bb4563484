"""Churn of the shared engine: scheduled join and leave alerts, and
identifier redraws.

The slot universe is fixed: joiners are dormant slots whose ``member``
flag flips when a decided join lands, leavers drop out of the member
mask. A ``ChurnSchedule`` gives each slot the tick its join-UP or
leave-DOWN alert batch is enqueued, guarded by the configuration epoch
expected then (a view change in between expires the alert). From the
enqueue on, the alert rides the monitor's pipeline: flush, delivery
(``cut.deliver_churn_reports``), aggregation, announce, vote, decide.

A joiner whose identifier collided redraws it at a scheduled tick
(``redraw_*`` fields): the dormant slot takes its new uid and fingerprint
limbs and ``topology.rank_and_insert`` moves its ring positions. The
``redraw_*`` fields are None when a schedule has no redraws.

Schedules come from the host: ``synthetic_churn_schedule`` (the benchmark
workload) here, or the reference's planner, whose output
``convert.from_reference`` carries to the device. The host planner that
replays the join protocol (``plan_churn``) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rapid_tpu_torch import hashing
from rapid_tpu_torch.engine import paxos, topology
from rapid_tpu_torch.engine.state import I32_MAX
from rapid_tpu_torch.identity import SEED_MEMBER
from rapid_tpu_torch.settings import Settings


class ChurnSchedule(NamedTuple):
    """Per-slot alert enqueue ticks (``I32_MAX`` = never), each with the
    epoch expected at that tick; numpy on the host, tensors on the
    device. ``redraw_tick[s]`` is when dormant slot ``s`` swaps in the
    uid limbs ``redraw_hi/lo`` and identifier-fingerprint limbs
    ``redraw_idfp_hi/lo`` (at most one slot per tick)."""

    join_tick: object                 # i32 [C]
    join_epoch: object                # i32 [C]
    leave_tick: object                # i32 [C]
    leave_epoch: object               # i32 [C]
    redraw_tick: object = None        # i32 [C], or None: no redraws
    redraw_hi: object = None          # limb [C]
    redraw_lo: object = None
    redraw_idfp_hi: object = None     # limb [C]
    redraw_idfp_lo: object = None


def empty_schedule(c: int) -> ChurnSchedule:
    """A host schedule with no joins, leaves or redraws."""
    return ChurnSchedule(
        join_tick=np.full(c, I32_MAX, np.int32),
        join_epoch=np.zeros(c, np.int32),
        leave_tick=np.full(c, I32_MAX, np.int32),
        leave_epoch=np.zeros(c, np.int32),
    )


def apply_redraws(state, schedule: ChurnSchedule, slot: int):
    """The state after dormant slot ``slot`` redraws its identifier: new
    uid, member-fingerprint and identifier-fingerprint limbs, its ring
    positions moved, and the topology and ring-0 positions re-scanned
    from the moved order. The caller picks ``slot``: the first slot with
    ``redraw_tick == t`` that is not a member."""
    def put(arr, value):
        arr = arr.clone()
        arr[slot] = value
        return arr

    new_hi = schedule.redraw_hi[slot]
    new_lo = schedule.redraw_lo[slot]
    uid_hi = put(state.uid_hi, new_hi)
    uid_lo = put(state.uid_lo, new_lo)
    mfp_hi, mfp_lo = hashing.hash64_limbs(new_hi, new_lo, seed=SEED_MEMBER)
    ring_order, ring_rank = topology.rank_and_insert(
        slot, uid_hi, uid_lo, state.ring_order, state.ring_rank)
    subj, obs, gk, fd_active, fd_first = topology.build_topology(
        state.member, ring_order, ring_rank)
    return state._replace(
        uid_hi=uid_hi, uid_lo=uid_lo,
        mfp_hi=put(state.mfp_hi, mfp_hi), mfp_lo=put(state.mfp_lo, mfp_lo),
        idfp_hi=put(state.idfp_hi, schedule.redraw_idfp_hi[slot]),
        idfp_lo=put(state.idfp_lo, schedule.redraw_idfp_lo[slot]),
        ring_order=ring_order, ring_rank=ring_rank,
        subj_idx=subj, obs_idx=obs, gk_idx=gk, fd_active=fd_active,
        fd_first=fd_first,
        px_pos=paxos.ring0_positions(state.member, ring_order, ring_rank))


def inject(state, schedule: ChurnSchedule, t: int):
    """``(churn_flush, injected)``: the alerts enqueued at tick ``t``
    whose epoch expectation holds, and their count (0-d int32)."""
    join_now = ((schedule.join_tick == t) & ~state.member
                & (schedule.join_epoch == state.epoch))
    leave_now = ((schedule.leave_tick == t) & state.member
                 & (schedule.leave_epoch == state.epoch))
    now = join_now | leave_now
    return state.churn_flush | now, now.sum().to(torch.int32)


def synthetic_churn_schedule(
    c: int, n_initial: int, settings: Settings, start: int = 10,
    period: Optional[int] = None, burst: int = 8,
) -> Tuple[ChurnSchedule, np.ndarray, dict]:
    """The sustained-churn benchmark workload, as the reference builds it.

    Cycle ``i`` activates ``burst`` fresh dormant slots (epoch ``2i``)
    and then removes exactly those slots (epoch ``2i + 1``), ``period``
    ticks apart, so the membership oscillates between ``n_initial`` and
    ``n_initial + burst``. Returns the host schedule, the identifier
    fingerprints (uint64 [C]) and ``{"bursts", "burst_size", "period",
    "last_decide"}``.
    """
    if period is None:
        period = settings.churn_decide_delay_ticks + 3
    if period <= settings.churn_decide_delay_ticks:
        raise ValueError("period must exceed the enqueue->decide delay")
    cycles = (c - n_initial) // burst
    schedule = empty_schedule(c)
    id_fps = np.zeros(c, np.uint64)
    for s in range(n_initial, c):
        id_fps[s] = np.uint64(hashing.hash64(s, seed=0x6964))
    last_decide = 0
    for cyc in range(cycles):
        slots = slice(n_initial + cyc * burst, n_initial + (cyc + 1) * burst)
        jt = start + (2 * cyc) * period
        lt = start + (2 * cyc + 1) * period
        schedule.join_tick[slots] = jt
        schedule.join_epoch[slots] = 2 * cyc
        schedule.leave_tick[slots] = lt
        schedule.leave_epoch[slots] = 2 * cyc + 1
        last_decide = lt + settings.churn_decide_delay_ticks
    info = {"bursts": 2 * cycles, "burst_size": burst, "period": period,
            "last_decide": last_decide}
    return schedule, id_fps, info
