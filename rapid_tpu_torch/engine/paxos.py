"""Classic Paxos: the shared engine's fallback and the per-receiver
engine's helpers.

When conflicting proposals split the fast round below its quorum, every
proposer's fallback timer (armed at ``propose``) may fire; the first
starts phase 1a with rank ``(2, classic_rank_index)``, acceptors promise
(1b, to the coordinator), the coordinator picks a value with the Fast
Paxos coordinator rule once a majority promised, and phases 2a/2b decide
at a ``> N/2`` accept count. The shared engine runs scripted contested
instances (a ``FallbackSchedule``, one row per instance, live while the
configuration epoch equals the row's ``inst_epoch``):

- ``chain_deliver``, ``fast_tally``, ``phase1a_deliver`` and
  ``task_phase`` are the tick's device phases, in the reference's order.
  Each takes the live instance's row ``e`` as a host int (``instance_row``
  on the host copy of ``inst_epoch``) and is called only while that
  instance is live: otherwise the reference's versions write nothing
  (``FallbackTicks`` says why).
- ``plan_fallback``, ``synthetic_contested_schedule`` and the rest of the
  host half compile scripted instances into numpy schedules and predict
  their outcome.

The per-receiver engine uses ``classic_rank_index``, ``ring0_positions``
and the host table of fallback-timer delays each slot can draw; all its
randomness is the per-slot ``random.Random`` streams of
``adversary_rngs``, as the reference's host referee draws them.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rapid_tpu_torch import hashing
from rapid_tpu_torch.engine.state import I32_MAX
from rapid_tpu_torch.engine.votes import (PROPOSAL_SEED, fast_quorum,
                                          segmented_vote_count)
from rapid_tpu_torch.settings import Settings

RANK_SEED = 0x72616E6B


def adversary_rngs(seed: int, n: int) -> List[random.Random]:
    """Per-slot jitter rngs, as the reference's host referee builds them."""
    return [random.Random(seed * 1000003 + slot) for slot in range(n)]


def classic_rank_index(uid_hi, uid_lo):
    """i32 [C]: the low 31 bits of ``hash64(uid, seed=RANK_SEED)``."""
    _, lo = hashing.hash64_limbs(uid_hi, uid_lo, seed=RANK_SEED)
    return (lo & 0x7FFFFFFF).to(torch.int32)


def ring0_positions(member, ring_order, ring_rank):
    """i32 ``[..., C]``: each member's position in ring-0 order among the
    members of its view; non-members read ``I32_MAX``."""
    member = member.to(torch.bool)
    order0 = ring_order[:, 0].to(torch.int64)
    rank0 = ring_rank[:, 0].to(torch.int64)
    mrank_s = torch.cumsum(member[..., order0].to(torch.int32), dim=-1) - 1
    mpos = mrank_s[..., rank0].to(torch.int32)
    return torch.where(member, mpos, I32_MAX).to(torch.int32)


def expovariate_delay_ticks(u: float, n: int, settings: Settings) -> int:
    """The oracle's fallback delay for uniform draw ``u`` and instance
    size ``n``: base delay plus expovariate jitter with rate 1/N."""
    jitter_ms = -1000.0 * math.log(1.0 - u) * n
    return settings.fallback_base_delay_ticks + max(
        0, round(jitter_ms / settings.tick_ms))


def build_delay_table(seed: int, capacity: int, n_draws: int,
                      settings: Settings) -> np.ndarray:
    """``table[slot, draw, m]``: the delay of each slot's ``draw``-th
    uniform at every instance size ``m`` in ``0..capacity`` (int32 numpy).

    Vectorised over ``m`` only, with the same float64 arithmetic as
    ``expovariate_delay_ticks``: one ``math.log`` per draw (numpy's log
    may differ in the last ulp), ``(-1000.0 * log) * m``, then ``np.rint``
    (half to even, like Python's ``round``) and the clamp at 0."""
    rngs = adversary_rngs(seed, capacity)
    m = np.arange(capacity + 1, dtype=np.float64)
    table = np.zeros((capacity, n_draws, capacity + 1), np.int32)
    for s in range(capacity):
        for d in range(n_draws):
            scale = -1000.0 * math.log(1.0 - rngs[s].random())
            ticks = np.rint((scale * m) / settings.tick_ms)
            table[s, d] = settings.fallback_base_delay_ticks + np.maximum(
                0.0, ticks).astype(np.int64)
    return table


# ---------------------------------------------------------------------------
# the shared engine's fallback schedule
# ---------------------------------------------------------------------------


class FallbackEnvelopeError(ValueError):
    """The contested scenario leaves what one shared view and one decide
    per tick can carry (tied first timers, a timer firing mid-count or
    mid-round, a propose landing mid-round). Such a scenario is
    executable all the same: ``engine.diff.run_adversarial_differential``
    runs it through the per-slot host adversary engine, and the message
    (the reference's, word for word) says so."""


class FallbackSchedule(NamedTuple):
    """Scripted contested instances, one row per instance; numpy on the
    host, tensors on the device. ``prop_pid[i, s] >= 0``: slot ``s``
    proposes ``table_mask[i, pid]`` at ``prop_tick[i, s]`` and arms its
    fallback timer for ``prop_delay[i, s]`` ticks. Instance ``i`` is live
    while the epoch equals ``inst_epoch[i]``. ``table_hi/lo`` are each
    proposal's ``votes.proposal_fingerprint`` limbs."""

    inst_epoch: object    # i32 [I]
    prop_tick: object     # i32 [I, C]
    prop_pid: object      # i32 [I, C]  (-1 = no vote)
    prop_delay: object    # i32 [I, C]
    table_mask: object    # bool [I, P, C]
    table_hi: object      # limb [I, P]
    table_lo: object


def empty_fallback_schedule(c: int, instances: int = 1,
                            pids: int = 1) -> FallbackSchedule:
    return FallbackSchedule(
        inst_epoch=np.arange(instances, dtype=np.int32),
        prop_tick=np.full((instances, c), I32_MAX, np.int32),
        prop_pid=np.full((instances, c), -1, np.int32),
        prop_delay=np.zeros((instances, c), np.int32),
        table_mask=np.zeros((instances, pids, c), bool),
        table_hi=np.zeros((instances, pids), np.uint32),
        table_lo=np.zeros((instances, pids), np.uint32),
    )


def instance_row(inst_epoch: np.ndarray, epoch: int) -> Tuple[int, bool]:
    """``(e, live)``: the schedule row of ``epoch`` (clipped into range)
    and whether that row's instance is live."""
    e = min(max(int(epoch), 0), len(inst_epoch) - 1)
    return e, bool(inst_epoch[e] == epoch)


def _wrap32(a: np.ndarray) -> np.ndarray:
    """int32 arithmetic as the device does it: wrap, never widen."""
    return a.astype(np.int64).astype(np.uint32).view(np.int32)


class FallbackTicks:
    """The host's view of a fallback schedule: the ticks on which each
    device phase can do anything, per instance row.

    Every timer of instance ``e`` is armed by a propose of that instance
    (``px_timer = prop_tick + prop_delay``), and every view change
    cancels all timers and the classic chain, so within an epoch timers
    fire only at ``fire[e]``; phase 1a lands one tick after a fire, 1b
    two, 2a three and 2b four. A fast-round vote is delivered from one
    tick after its propose, and the delivered set changes only at those
    ticks (the member mask changes only with the epoch). Off those ticks
    the reference's phases write nothing and count 0, so the engine skips
    them.
    """

    def __init__(self, prop_tick, prop_pid, prop_delay, inst_epoch):
        self.inst_epoch = np.asarray(inst_epoch)
        voter = np.asarray(prop_pid) >= 0
        tick = np.asarray(prop_tick)
        rows = range(len(self.inst_epoch))
        self.send = [set(tick[e][voter[e]].tolist()) for e in rows]
        fire = _wrap32(tick.astype(np.int64) + np.asarray(prop_delay))
        self.fire = [set(fire[e][voter[e]].tolist()) for e in rows]
        # The reference adds 1 to int32 ticks: I32_MAX wraps to the least
        # int32, which is at or before every tick.
        arrive = _wrap32(tick.astype(np.int64) + 1)
        self.arrivals = [np.unique(arrive[e][voter[e]]) for e in rows]

    def row(self, epoch: int) -> Tuple[int, bool]:
        return instance_row(self.inst_epoch, epoch)

    def arrived(self, e: int, t: int) -> int:
        """How many distinct vote-arrival ticks of row ``e`` are at or
        before ``t``; 0 when no vote is delivered yet."""
        return int(np.searchsorted(self.arrivals[e], t, side="right"))

    def fired_before(self, e: int, t: int, *lags: int) -> bool:
        return any(t - lag in self.fire[e] for lag in lags)


def rank_lt(ar, ai, br, bi):
    """(ar, ai) < (br, bi) lexicographically (the oracle's rank order)."""
    return (ar < br) | ((ar == br) & (ai < bi))


def rank_eq(ar, ai, br, bi):
    return (ar == br) & (ai == bi)


def coordinator_rule_pid(promised, pos, vval_pid, n, n_pids: int):
    """The Fast Paxos coordinator rule over the promises' ring-0 arrival
    order; 0-d int32 pid, or -1 when no promise carries a value.

    Over the prefix of ``max(N//2 + 1, first valued position + 1)``
    arrivals: the one voted value if there is one; else the value whose
    ``(N//4 + 1)``-th occurrence comes first; else the first voted value.
    ``torch.sort`` sorts values here, so stability does not matter;
    ``argmax`` runs on uint8 and ``argmin`` takes the first minimum, as
    the reference's do.
    """
    big = I32_MAX
    n4 = torch.div(n, 4, rounding_mode="floor").to(torch.int32)
    has_val = promised & (vval_pid >= 0)
    pos_hv = torch.where(has_val, pos, big)
    first_hv = pos_hv.min()
    m_star = torch.maximum(torch.div(n, 2, rounding_mode="floor") + 1,
                           first_hv + 1)
    cand = has_val & (pos < m_star)
    pid_ids = torch.arange(n_pids, dtype=torch.int32, device=pos.device)
    pid_masks = cand[None, :] & (vval_pid[None, :] == pid_ids[:, None])
    cnt = pid_masks.sum(dim=1).to(torch.int32)
    distinct = (cnt > 0).sum().to(torch.int32)
    single_pid = torch.argmax((cnt > 0).to(torch.uint8)).to(torch.int32)
    sorted_pos = torch.sort(torch.where(pid_masks, pos[None, :], big),
                            dim=1).values
    nth = sorted_pos.index_select(1, n4.reshape(1).long())[:, 0]
    cross = torch.where(cnt >= n4 + 1, nth, big)
    cross_pid = torch.argmin(cross).to(torch.int32)
    has_cross = cross.min() < big
    fb_pid = vval_pid[torch.argmin(pos_hv)]
    chosen = torch.where(distinct == 1, single_pid,
                         torch.where(has_cross, cross_pid, fb_pid))
    return torch.where(has_val.any(), chosen, -1).to(torch.int32)


def chain_deliver(state, sched: FallbackSchedule, t: int, n):
    """Classic-chain deliveries at tick ``t``, in the reference's order
    2b, 2a, 1b (they were sent in the last tick's delivery phase, so they
    land before fast-round votes). Returns ``(state, counts,
    classic_decide, classic_pid)``; a 2b majority blocks the later
    stages. ``n`` is the tick's opening member count (0-d int32)."""
    epoch = state.epoch
    maj = torch.div(n, 2, rounding_mode="floor")
    i32 = lambda x: x.to(torch.int32)

    # -- phase 2b: everyone counts accept votes; decide past majority ----
    arr2b = (state.c2b_tick + 1 == t) & (state.c2b_epoch == epoch)
    classic_decide = arr2b & (state.c2b_cnt > maj)
    classic_pid = state.c2b_pid
    gate = ~classic_decide

    # -- phase 2a: acceptors accept and broadcast phase 2b ---------------
    arr2a = gate & (state.c2a_tick + 1 == t) & (state.c2a_epoch == epoch)
    accept = (state.member
              & ~rank_lt(state.c2a_rank_r, state.c2a_rank_i,
                         state.px_rnd_r, state.px_rnd_i)
              & ~rank_eq(state.px_vrnd_r, state.px_vrnd_i,
                         state.c2a_rank_r, state.c2a_rank_i) & arr2a)
    n_accept = i32(accept.sum())
    state = state._replace(
        px_rnd_r=torch.where(accept, state.c2a_rank_r, state.px_rnd_r),
        px_rnd_i=torch.where(accept, state.c2a_rank_i, state.px_rnd_i),
        px_vrnd_r=torch.where(accept, state.c2a_rank_r, state.px_vrnd_r),
        px_vrnd_i=torch.where(accept, state.c2a_rank_i, state.px_vrnd_i),
        px_vval=torch.where(accept, state.c2a_pid, state.px_vval),
        c2b_tick=i32(torch.where(arr2a, t, state.c2b_tick)),
        c2b_cnt=torch.where(arr2a, n_accept, state.c2b_cnt),
        c2b_pid=torch.where(arr2a, state.c2a_pid, state.c2b_pid),
        c2b_epoch=torch.where(arr2a, epoch, state.c2b_epoch),
    )

    # -- phase 1b: the coordinator applies the rule past majority --------
    arr1b = gate & (state.c1b_tick + 1 == t) & (state.c1b_epoch == epoch)
    n_promise = i32(state.c1b_mask.sum())
    chosen = coordinator_rule_pid(state.c1b_mask, state.px_pos,
                                  state.px_vval, n,
                                  sched.table_mask.shape[1])
    do2a = arr1b & (n_promise > maj) & (chosen >= 0)
    slots = torch.arange(state.px_cval.shape[0], device=chosen.device)
    state = state._replace(
        c2a_tick=i32(torch.where(do2a, t, state.c2a_tick)),
        c2a_pid=torch.where(do2a, chosen, state.c2a_pid),
        c2a_rank_r=torch.where(do2a, state.c1a_rank_r, state.c2a_rank_r),
        c2a_rank_i=torch.where(do2a, state.c1a_rank_i, state.c2a_rank_i),
        c2a_epoch=torch.where(do2a, epoch, state.c2a_epoch),
        px_cval=torch.where(do2a & (slots == state.c1a_coord), chosen,
                            state.px_cval),
    )
    zero = torch.zeros_like(n_accept)
    counts = {
        "px2a_senders": i32(do2a),
        "px2a_recipients": torch.where(do2a, n, zero),
        "px2b_senders": torch.where(arr2a, n_accept, zero),
        "px2b_recipients": torch.where(arr2a, n, zero),
    }
    return state, counts, classic_decide, classic_pid


def fast_tally(state, sched: FallbackSchedule, e: int, t: int, n):
    """The scripted fast round of row ``e`` at tick ``t``: ``(ok,
    win_pid, tally, quorum)``. A vote sent at its propose tick arrives
    one tick later; the reference's ``decided`` is ``ok & ~blocked``.
    The three stable sorts of ``segmented_vote_count`` are the cost."""
    pid = sched.prop_pid[e]
    delivered = state.member & (pid >= 0) & (sched.prop_tick[e] + 1 <= t)
    safe_pid = pid.clamp(0, sched.table_mask.shape[1] - 1).long()
    per_vote = segmented_vote_count(sched.table_hi[e][safe_pid],
                                    sched.table_lo[e][safe_pid], delivered)
    total = delivered.sum().to(torch.int32)
    quorum = fast_quorum(n)
    best = per_vote.max()
    ok = (total >= quorum) & (best >= quorum)
    win_pid = torch.where(delivered & (per_vote >= quorum), pid,
                          I32_MAX).min()
    tally = torch.where(total > 0, best, 0).to(torch.int32)
    return ok, win_pid, tally, quorum


def phase1a_deliver(state, t: int):
    """Phase-1a delivery at tick ``t`` (last in the delivery phase: the
    broadcast was a task-phase send) on a tick that did not decide:
    acceptors below the coordinator's rank promise. Returns ``(state,
    px1b_senders)``."""
    epoch = state.epoch
    arr1a = (state.c1a_tick + 1 == t) & (state.c1a_epoch == epoch)
    promise = state.member & rank_lt(state.px_rnd_r, state.px_rnd_i,
                                     state.c1a_rank_r, state.c1a_rank_i) \
        & arr1a
    n_promise = promise.sum().to(torch.int32)
    state = state._replace(
        px_rnd_r=torch.where(promise, state.c1a_rank_r, state.px_rnd_r),
        px_rnd_i=torch.where(promise, state.c1a_rank_i, state.px_rnd_i),
        c1b_mask=torch.where(arr1a, promise, state.c1b_mask),
        c1b_tick=torch.where(arr1a, t, state.c1b_tick).to(torch.int32),
        c1b_epoch=torch.where(arr1a, epoch, state.c1b_epoch),
    )
    return state, torch.where(arr1a, n_promise, torch.zeros_like(n_promise))


def task_phase(state, sched: FallbackSchedule, e: int, t: int, n,
               send: bool, fire: bool):
    """Task-phase sends of row ``e`` at tick ``t`` on a tick that did not
    decide, or whose decide made row ``e`` live: scripted proposes (vote
    broadcast, own-vote registration, timer arming), then timer fires
    (phase-1a broadcast). ``send``/``fire`` say whether the host's
    ``FallbackTicks`` allows either this tick. Returns ``(state,
    counts)``; counts are absent for the half that was skipped."""
    i32 = lambda x: x.to(torch.int32)
    counts = {}
    if send:
        pid = sched.prop_pid[e]
        sends = state.member & (pid >= 0) & (sched.prop_tick[e] == t)
        n_send = i32(sends.sum())
        # The vote registers only while the slot's rank round is <= 1.
        reg = sends & (state.px_rnd_r <= 1)
        state = state._replace(
            px_rnd_r=i32(torch.where(reg, 1, state.px_rnd_r)),
            px_rnd_i=i32(torch.where(reg, 1, state.px_rnd_i)),
            px_vrnd_r=i32(torch.where(reg, 1, state.px_vrnd_r)),
            px_vrnd_i=i32(torch.where(reg, 1, state.px_vrnd_i)),
            px_vval=torch.where(reg, pid, state.px_vval),
            px_timer=torch.where(sends, t + sched.prop_delay[e],
                                 state.px_timer),
        )
        counts["pxvote_senders"] = n_send
        counts["pxvote_recipients"] = torch.where(
            sends.any(), n, torch.zeros_like(n))
    if fire:
        fires = state.member & (state.px_timer == t)
        n_fire = i32(fires.sum())
        coord = torch.argmax(fires.to(torch.uint8))
        rank_i = classic_rank_index(state.uid_hi[coord], state.uid_lo[coord])
        any_fire = fires.any()
        at_coord = any_fire & (torch.arange(fires.shape[0],
                                             device=fires.device) == coord)
        state = state._replace(
            px_timer=i32(torch.where(fires, I32_MAX, state.px_timer)),
            c1a_tick=i32(torch.where(any_fire, t, state.c1a_tick)),
            c1a_coord=torch.where(any_fire, i32(coord), state.c1a_coord),
            c1a_rank_r=i32(torch.where(any_fire, 2, state.c1a_rank_r)),
            c1a_rank_i=torch.where(any_fire, rank_i, state.c1a_rank_i),
            c1a_epoch=torch.where(any_fire, state.epoch, state.c1a_epoch),
            px_crnd_r=i32(torch.where(at_coord, 2, state.px_crnd_r)),
            px_crnd_i=torch.where(at_coord, rank_i, state.px_crnd_i),
        )
        counts["px1a_senders"] = n_fire
        counts["px1a_recipients"] = torch.where(any_fire, n,
                                                torch.zeros_like(n))
    return state, counts


# ---------------------------------------------------------------------------
# host planner: envelope validation and outcome prediction (numpy)
# ---------------------------------------------------------------------------


def _default_uids(c: int) -> np.ndarray:
    from rapid_tpu_torch.identity import default_endpoints, uid_of

    return np.asarray([uid_of(e) for e in default_endpoints(c)], np.uint64)


def np_ring0_positions(uids: np.ndarray, member: np.ndarray) -> np.ndarray:
    """``ring0_positions`` on the host (int32 numpy), with its own ring-0
    sort of ``uids``."""
    from rapid_tpu_torch.engine.topology import ring_permutations

    hi, lo = hashing.np_to_limbs(np.asarray(uids, np.uint64))
    order, rank = ring_permutations(torch.from_numpy(hi.astype(np.int64)),
                                    torch.from_numpy(lo.astype(np.int64)), 1)
    return ring0_positions(torch.from_numpy(np.asarray(member, bool)),
                           torch.from_numpy(order),
                           torch.from_numpy(rank)).numpy()


def host_coordinator_rule(n: int, positions: Dict[int, int],
                          votes: Dict[int, int]) -> int:
    """``coordinator_rule_pid`` in Python over slot -> ring-0 position and
    slot -> pid maps (voters only)."""
    if not votes:
        return -1
    order = sorted(votes, key=lambda s: positions[s])
    first = positions[order[0]]
    m_star = max(n // 2 + 1, first + 1)
    pids = [votes[s] for s in order if positions[s] < m_star]
    if len(set(pids)) == 1:
        return pids[0]
    counters: Dict[int, int] = {}
    for value in pids:
        count = counters.setdefault(value, 0)
        if count + 1 > n // 4:
            return value
        counters[value] = count + 1
    return pids[0]


def plan_fallback(
    n: int,
    values: Sequence[Sequence[int]],
    votes: Dict[int, Tuple[int, int]],
    delays: Dict[int, int],
    settings: Settings,
    uids: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    epoch: int = 0,
    member: Optional[np.ndarray] = None,
) -> Tuple[FallbackSchedule, Dict[str, object]]:
    """One contested instance as a host schedule, checked against the
    envelope, with its predicted outcome.

    ``values[p]`` lists the member slots proposal ``p`` removes;
    ``votes[s] = (tick, pid)`` scripts slot ``s``'s propose;
    ``delays[s]`` is its fallback delay in ticks. ``member`` is the live
    electorate (bool ``[capacity]``, default slots ``[0, n)``); ``uids``
    default to the default endpoints' identities. Raises
    ``FallbackEnvelopeError`` outside the envelope. Returns the
    single-instance schedule and ``{"n", "quorum", "mode",
    "decide_tick", "winner", ...}``.
    """
    c = capacity if capacity is not None else n
    if member is None:
        member = np.zeros(c, bool)
        member[:n] = True
    else:
        member = np.asarray(member, bool)
    n_live = int(member.sum())
    if not values:
        raise FallbackEnvelopeError("need at least one proposal value")
    for p, val in enumerate(values):
        if not val:
            raise FallbackEnvelopeError(f"proposal {p} is empty")
        if any(s < 0 or s >= c or not member[s] for s in val):
            raise FallbackEnvelopeError(f"proposal {p} removes a non-member")
    if not votes:
        raise FallbackEnvelopeError("need at least one scripted propose")
    for s, (tick, pid) in votes.items():
        if s < 0 or s >= c or not member[s]:
            raise FallbackEnvelopeError(f"voter {s} is not a member")
        if not 0 <= pid < len(values):
            raise FallbackEnvelopeError(f"voter {s} votes unknown pid {pid}")
        if tick < 1:
            raise FallbackEnvelopeError(
                f"voter {s} proposes at tick {tick}; scripted proposes "
                "need tick >= 1")
        if s not in delays:
            raise FallbackEnvelopeError(f"voter {s} has no fallback delay")
        if delays[s] < 1:
            raise FallbackEnvelopeError(f"voter {s} delay must be >= 1")

    # Replay the fast-round tally on virtual time to find the decide tick.
    quorum = n_live - (n_live - 1) // 4
    by_arrival: Dict[int, List[int]] = {}
    for s, (tick, pid) in votes.items():
        by_arrival.setdefault(tick + 1, []).append(pid)
    counts: Dict[int, int] = {}
    total = 0
    fast_decide_tick = fast_pid = None
    for arr in sorted(by_arrival):
        for pid in by_arrival[arr]:
            counts[pid] = counts.get(pid, 0) + 1
            total += 1
        if fast_decide_tick is None and total >= quorum:
            best = max(counts, key=lambda p: counts[p])
            if counts[best] >= quorum:
                fast_decide_tick, fast_pid = arr, best

    fires = {s: votes[s][0] + delays[s] for s in votes}
    min_fire = min(fires.values())
    info: Dict[str, object] = {"n": n_live, "quorum": quorum}
    if fast_decide_tick is not None:
        # A fire one tick before the fast decision puts a phase 1a on the
        # wire that dies on arrival; an earlier one starts a real round.
        if min_fire < fast_decide_tick - 1:
            raise FallbackEnvelopeError(
                f"timer fires at {min_fire}, before the fast decision at "
                f"{fast_decide_tick} completes — outside the fleet-kernel "
                "envelope; run this mid-fast-count fire through "
                "run_adversarial_differential")
        info.update(mode="fast", decide_tick=fast_decide_tick,
                    winner=fast_pid,
                    racing=bool(min_fire == fast_decide_tick - 1))
    else:
        firing = [s for s, f in fires.items() if f == min_fire]
        if len(firing) != 1:
            raise FallbackEnvelopeError(
                f"{len(firing)} timers fire together at {min_fire}; the "
                "fleet kernel needs a unique first coordinator — run tied "
                "timers through run_adversarial_differential")
        decide = min_fire + 4  # 1a -> 1b -> 2a -> 2b -> decide
        late = [s for s, f in fires.items()
                if s != firing[0] and f < decide]
        if late:
            raise FallbackEnvelopeError(
                f"timers of {late} fire during the classic round "
                f"({min_fire}..{decide}); the oracle starts a rank race the "
                "fleet kernel cannot carry — run it through "
                "run_adversarial_differential")
        late_votes = [s for s, (tick, _) in votes.items() if tick >= min_fire]
        if late_votes:
            raise FallbackEnvelopeError(
                f"proposes of {late_votes} land mid-classic-round — run "
                "them through run_adversarial_differential")
        if uids is None:
            uids = _default_uids(c)
        pos = np_ring0_positions(np.asarray(uids, np.uint64), member)
        winner = host_coordinator_rule(
            n_live, {s: int(pos[s]) for s in votes},
            {s: pid for s, (_, pid) in votes.items()})
        info.update(mode="classic", decide_tick=decide, winner=winner,
                    coordinator=firing[0], fire_tick=min_fire)

    sched = empty_fallback_schedule(c, instances=1, pids=len(values))
    sched.inst_epoch[0] = epoch
    voters = np.fromiter(votes, np.int64, len(votes))
    sched.prop_tick[0, voters] = [votes[s][0] for s in voters.tolist()]
    sched.prop_pid[0, voters] = [votes[s][1] for s in voters.tolist()]
    sched.prop_delay[0, voters] = [delays[s] for s in voters.tolist()]
    for p, val in enumerate(values):
        sched.table_mask[0, p, list(val)] = True
    _fingerprint_tables(sched, uids, c)
    return sched, info


def _fingerprint_tables(sched: FallbackSchedule, uids, c: int) -> None:
    """Fill ``table_hi``/``table_lo`` from the masks: each proposal's
    ``proposal_fingerprint``, summed in Python ints over its slots."""
    if uids is None:
        uids = _default_uids(c)
    uids = np.asarray(uids, np.uint64)
    for i in range(sched.table_mask.shape[0]):
        for p in range(sched.table_mask.shape[1]):
            total = sum(hashing.hash64(int(u), seed=PROPOSAL_SEED)
                        for u in uids[sched.table_mask[i, p]])
            hi, lo = hashing.to_limbs(
                hashing.splitmix64(total & hashing.MASK64))
            sched.table_hi[i, p] = hi
            sched.table_lo[i, p] = lo


def concat_schedules(parts: Sequence[FallbackSchedule]) -> FallbackSchedule:
    """Stack single-instance host schedules into one."""
    return FallbackSchedule(*[np.concatenate([getattr(p, f) for p in parts])
                              for f in FallbackSchedule._fields])


def synthetic_contested_schedule(
    n: int, settings: Settings, n_ticks: int, start: int = 5,
    period: Optional[int] = None, uids: Optional[np.ndarray] = None,
) -> Tuple[FallbackSchedule, Dict[str, object]]:
    """The contested benchmark workload, as the reference builds it.

    Every ``period`` ticks the members split into two camps that propose
    removing two different members (the two highest slots); no fast
    quorum forms, the lowest member's timer fires after the base delay
    and the classic round decides 4 ticks later. The predicted winner
    shapes the next instance's electorate. ``uids`` must be the state's
    identities (default: the default endpoints'). Returns the host
    schedule and ``{"instances", "decide_ticks", "period"}``.
    """
    if uids is None:
        uids = _default_uids(n)
    base = settings.fallback_base_delay_ticks
    round_len = base + 4
    if period is None:
        period = round_len + 6
    member = np.ones(n, bool)
    parts: List[FallbackSchedule] = []
    decides: List[int] = []
    tick = start
    epoch = 0
    while tick + round_len < n_ticks and member.sum() > 4:
        members = np.nonzero(member)[0]
        victims = members[-2:]
        values = [[int(victims[0])], [int(victims[1])]]
        votes = {int(s): (tick, int(i % 2)) for i, s in enumerate(members)}
        delays = {int(s): (base if s == members[0] else base + period)
                  for s in members}
        sched, info = plan_fallback(
            n, values, votes, delays, settings, uids=uids, capacity=n,
            epoch=epoch, member=member.copy())
        parts.append(sched)
        decides.append(int(info["decide_tick"]))
        member[values[int(info["winner"])]] = False
        tick += period
        epoch += 1
    info = {"instances": len(parts), "decide_ticks": decides,
            "period": period}
    if not parts:
        return empty_fallback_schedule(n), info
    return concat_schedules(parts), info
