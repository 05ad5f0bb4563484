"""Churn of the shared engine: scheduled join and leave alerts, identifier
redraws, and the host planner that schedules them.

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

Schedules come from the host: ``plan_churn`` replays the oracle's join
protocol (two-phase gatekeeping, node-id retries on UUID collisions,
graceful-leave hops, the failure detectors' notify bookkeeping) against
the ``oracle`` mirrors and compiles it to enqueue ticks, raising
``ChurnEnvelopeError`` on the tick a scenario leaves the envelope in
which the batched engine equals the oracle: one alert pipeline in flight
at a time, no view change between a join's phase 1 and its enqueue or
inside a leave hop, exactly one proposal per burst holding all its
destinations (the planner replays the detector's sequential per-batch
aggregation and rejects a partial emission), joins deciding before their
timeout, the seed, leavers and joiners alive through their hops, and no
joiner wired on an FD-interval tick under crash faults.
``synthetic_churn_schedule`` is the benchmark workload.
``convert.from_reference`` carries a host schedule to the device.

On a slot mesh (``group``) ``inject`` all-reduces its count and
``apply_redraws`` lets the slot's owner write its identity; the ring
tables move and the topology is rebuilt on all-gathered tables, and each
shard keeps its rows.

Joiner node ids come from the cluster rng (``oracle.cluster.default_rng``),
seeded from a salted ``str`` hash: a plan is reproducible across processes
only under one ``PYTHONHASHSEED``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rapid_tpu_torch import hashing
from rapid_tpu_torch.engine import paxos, topology
from rapid_tpu_torch.engine.sharding import SOLO
from rapid_tpu_torch.engine.state import I32_MAX
from rapid_tpu_torch.identity import SEED_MEMBER, id_fingerprint, uid_of
from rapid_tpu_torch.oracle.cluster import default_rng
from rapid_tpu_torch.oracle.cut_detector import MultiNodeCutDetector
from rapid_tpu_torch.oracle.membership_view import MembershipView
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import (AlertMessage, EdgeStatus, Endpoint,
                                   JoinStatusCode, NodeId)


class ChurnEnvelopeError(ValueError):
    """The scenario leaves the envelope in which the batched engine
    equals the oracle (see the module docstring)."""


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


def apply_redraws(state, schedule: ChurnSchedule, slot: int, group=SOLO):
    """The state after dormant slot ``slot`` redraws its identifier: new
    uid, member-fingerprint and identifier-fingerprint limbs, its ring
    positions moved, and the topology and ring-0 positions re-scanned
    from the moved order. The caller picks ``slot``: the first slot with
    ``redraw_tick == t`` that is not a member. On a slot mesh the shard
    that holds ``slot`` writes it; the ring tables move and the topology
    is rebuilt on the all-gathered tables, and each shard keeps its
    rows."""
    at = slot - group.lo
    own = 0 <= at < state.uid_hi.shape[0]

    def put(arr, value):
        if not own:
            return arr
        arr = arr.clone()
        arr[at] = value
        return arr

    uid_hi, uid_lo = state.uid_hi, state.uid_lo
    mfp_hi, mfp_lo = state.mfp_hi, state.mfp_lo
    idfp_hi, idfp_lo = state.idfp_hi, state.idfp_lo
    if own:
        new_hi = schedule.redraw_hi[at]
        new_lo = schedule.redraw_lo[at]
        uid_hi = put(uid_hi, new_hi)
        uid_lo = put(uid_lo, new_lo)
        new_mhi, new_mlo = hashing.hash64_limbs(new_hi, new_lo,
                                                seed=SEED_MEMBER)
        mfp_hi, mfp_lo = put(mfp_hi, new_mhi), put(mfp_lo, new_mlo)
        idfp_hi = put(idfp_hi, schedule.redraw_idfp_hi[at])
        idfp_lo = put(idfp_lo, schedule.redraw_idfp_lo[at])
    uid_hi_all, uid_lo_all, order_all, rank_all, member_all = group.all_gather(
        uid_hi, uid_lo, state.ring_order, state.ring_rank, state.member)
    ring_order, ring_rank = topology.rank_and_insert(
        slot, uid_hi_all, uid_lo_all, order_all, rank_all)
    tables = topology.build_topology(member_all, ring_order, ring_rank)
    subj, obs, gk, fd_active, fd_first = (group.local(x) for x in tables)
    return state._replace(
        uid_hi=uid_hi, uid_lo=uid_lo, mfp_hi=mfp_hi, mfp_lo=mfp_lo,
        idfp_hi=idfp_hi, idfp_lo=idfp_lo,
        ring_order=group.local(ring_order), ring_rank=group.local(ring_rank),
        subj_idx=subj, obs_idx=obs, gk_idx=gk, fd_active=fd_active,
        fd_first=fd_first,
        px_pos=group.local(paxos.ring0_positions(member_all, ring_order,
                                                 ring_rank)))


def inject(state, schedule: ChurnSchedule, t: int, group=SOLO):
    """``(churn_flush, injected)``: the alerts enqueued at tick ``t``
    whose epoch expectation holds, and their count (0-d int32,
    all-reduced on a slot mesh)."""
    join_now = ((schedule.join_tick == t) & ~state.member
                & (schedule.join_epoch == state.epoch))
    leave_now = ((schedule.leave_tick == t) & state.member
                 & (schedule.leave_epoch == state.epoch))
    now = join_now | leave_now
    return (state.churn_flush | now,
            group.sum(now.sum()).to(torch.int32))


@dataclass
class ChurnPlan:
    """Output of ``plan_churn``: the host schedule (numpy) and the
    planner's prediction of the protocol-visible events, as
    ``(tick, kind, config_id, slots)``."""

    schedule: ChurnSchedule
    id_fps: np.ndarray                   # uint64 [C] identifier fingerprints
    joiner_ids: Dict[int, NodeId]        # slot -> decided NodeId
    wired: Dict[int, int]                # slot -> tick its service starts
    events: List[Tuple[int, str, int, Tuple[int, ...]]]
    final_members: frozenset
    final_config_id: int
    redraws: Dict[int, int] = None       # slot -> scheduled redraw tick

    def __post_init__(self):
        if self.redraws is None:
            self.redraws = {}


def plan_churn(
    endpoints: Sequence[Endpoint],
    initial_n: int,
    node_ids: Sequence[NodeId],
    n_ticks: int,
    settings: Settings,
    joins: Optional[Dict[int, int]] = None,
    leaves: Optional[Dict[int, int]] = None,
    crashes: Optional[Dict[int, int]] = None,
    seed_slot: int = 0,
) -> ChurnPlan:
    """Compile a churn scenario into a host schedule, as the reference's
    planner does.

    ``endpoints`` is the full slot universe (initial members first, then
    dormant joiner slots; ``Endpoint`` or ``(hostname, port)``),
    ``node_ids`` the initial members' ids, ``joins``/``leaves`` map slot
    -> the tick the host calls ``join(seed)`` / ``leave_gracefully()``,
    and ``crashes`` slot -> crash tick (the faults handed to the engine).
    The planner advances a mirror of the oracle tick by tick (view,
    failure-detector counters, the single alert pipeline) and raises
    ``ChurnEnvelopeError`` on the tick the scenario leaves the envelope.
    """
    endpoints = [Endpoint.of(e) for e in endpoints]
    node_ids = [NodeId.of(i) for i in node_ids]
    joins = dict(joins or {})
    leaves = dict(leaves or {})
    crashes = dict(crashes or {})
    c = len(endpoints)
    if not (0 < initial_n <= c):
        raise ValueError(f"initial_n {initial_n} out of range for C={c}")
    if len(node_ids) < initial_n:
        raise ValueError("need a NodeId per initial member")
    for s, t0 in joins.items():
        if not (initial_n <= s < c):
            raise ChurnEnvelopeError(
                f"join slot {s} is not a dormant slot (initial membership "
                f"owns [0, {initial_n}))")
        if t0 < 1:
            raise ValueError(f"join tick {t0} for slot {s} must be >= 1")
    for s, t0 in leaves.items():
        if not (0 <= s < c):
            raise ValueError(f"leave slot {s} out of range")
        if t0 < 1:
            raise ValueError(f"leave tick {t0} for slot {s} must be >= 1")

    view = MembershipView(settings.K, list(node_ids[:initial_n]),
                          list(endpoints[:initial_n]))
    slot_of = {e: i for i, e in enumerate(endpoints)}
    members = set(range(initial_n))
    creation_order = list(range(initial_n))
    epoch = 0
    fd_gate = 0
    fd_cnt: Dict[int, int] = {}
    fd_notified: set = set()
    pending: Optional[dict] = None
    leave_epochs: Dict[int, int] = {}
    events: List[Tuple[int, str, int, Tuple[int, ...]]] = []
    wired: Dict[int, int] = {}
    interval = settings.fd_interval_ticks

    def alive(s: int, t: int) -> bool:
        ct = crashes.get(s)
        return ct is None or t < ct

    # Joiner state machines. The NodeId sequence replicates the oracle's
    # Cluster rng exactly (same seed formula, same draw order: one 128-bit
    # id per attempt, drawn before the service ever touches the rng).
    js: Dict[int, dict] = {}
    for s, t0 in joins.items():
        rng = default_rng(settings, endpoints[s])
        first_id = NodeId(rng.getrandbits(64), rng.getrandbits(64))
        js[s] = {
            "attempt": 1, "start": t0,
            "node_id": first_id, "first_id": first_id, "redraw": None,
            "rng": rng, "p1_epoch": None, "enq": None, "done": False,
        }

    def announce_sim(dsts: Dict[int, str], t_ann: int) -> Optional[set]:
        """Replay the oracle's sequential per-batch cut aggregation at the
        delivery tick; returns the first emitted proposal as a slot set,
        or None if the burst never emits."""
        det = MultiNodeCutDetector(settings.K, settings.H, settings.L)
        batches: Dict[int, list] = {}
        for d, kind in dsts.items():
            ep = endpoints[d]
            if kind == "join":
                srcs = view.get_expected_observers_of(ep)
                status = EdgeStatus.UP
            else:
                srcs = view.get_observers_of(ep)
                status = EdgeStatus.DOWN
            per_src: Dict[Endpoint, List[int]] = {}
            for ring, src_ep in enumerate(srcs):
                per_src.setdefault(src_ep, []).append(ring)
            for src_ep, rings in per_src.items():
                src = slot_of[src_ep]
                if not alive(src, t_ann):
                    continue  # batch dropped at delivery, sender crashed
                batches.setdefault(src, []).append((kind, d, AlertMessage(
                    edge_src=src_ep, edge_dst=ep, edge_status=status,
                    configuration_id=0, ring_numbers=tuple(rings))))
        # Batches arrive in the senders' service-creation order (the
        # scheduler-handle order of their periodic batcher jobs); within a
        # batch, leave/join alerts (message deliveries, in sender-op
        # order = destination slot order under the harness's sorted
        # scheduling) precede crash notifications (run-due FD tasks,
        # which fire in the source's failure-detector creation order:
        # its subjects deduplicated in ring order).
        kind_rank = {"leave": 0, "join": 1, "crash": 2}

        def alert_order(src_ep: Endpoint):
            fd_order = {e: i for i, e in enumerate(
                dict.fromkeys(view.get_subjects_of(src_ep)))}

            def key(a):
                kind, d, _ = a
                return (kind_rank[kind],
                        fd_order.get(endpoints[d], d) if kind == "crash"
                        else d)
            return key

        for src in (s for s in creation_order if s in batches):
            prop: Dict[Endpoint, None] = {}
            for _, _, alert in sorted(
                    batches[src], key=alert_order(endpoints[src])):
                for node in det.aggregate_for_proposal(alert):
                    prop[node] = None
            for node in det.invalidate_failing_edges(view):
                prop[node] = None
            if prop:
                return {slot_of[e] for e in prop}
        return None

    schedule = empty_schedule(c)

    for t in range(1, n_ticks + 1):
        # -- A: fast-round votes arrive; a quorum decides the view change
        if pending is not None and pending["decide"] == t:
            nm = pending["n"]
            votes_alive = sum(1 for v in pending["voters"] if alive(v, t))
            if votes_alive < nm - (nm - 1) // 4:
                raise ChurnEnvelopeError(
                    f"tick {t}: only {votes_alive}/{nm} fast-round votes "
                    "survive to the decide tick — no fast quorum, the "
                    "oracle would fall back to classic paxos")
            if not any(alive(m, t) for m in members):
                raise ChurnEnvelopeError(
                    f"tick {t}: no alive member left to count the votes")
            dsts = pending["dsts"]
            removed = sorted(d for d in dsts if d in members)
            joined = [d for d in dsts if d not in members]
            for d in removed:
                view.ring_delete(endpoints[d])
                members.discard(d)
            for d in joined:
                view.ring_add(endpoints[d], js[d]["node_id"])
                members.add(d)
            epoch += 1
            fd_gate = t
            fd_cnt.clear()
            fd_notified.clear()
            events.append((t, "view_change",
                           view.get_current_configuration_id(),
                           tuple(sorted(dsts))))
            # Joiners get their parked SAFE_TO_JOIN response one hop
            # later, in proposal (ring-0 hash) order -> service creation
            # order for the batch pipeline.
            for d in sorted(joined,
                            key=lambda d: view.ring0_sort_key(endpoints[d])):
                st = js[d]
                st["done"] = True
                wired[d] = t + 1
                if not (t + 1 < st["start"] + settings.join_timeout_ticks):
                    raise ChurnEnvelopeError(
                        f"slot {d}: join decided at tick {t} but the "
                        f"response at {t + 1} loses to the timeout retry "
                        f"scheduled at {st['start']}+"
                        f"{settings.join_timeout_ticks}")
                if crashes and (t + 1) % interval == 0:
                    raise ChurnEnvelopeError(
                        f"slot {d}: wired at tick {t + 1}, an FD-interval "
                        "multiple — under crash faults the joiner's "
                        "detectors would skip it but the engine's fd_gate "
                        "would not")
                if not alive(d, t + 1):
                    raise ChurnEnvelopeError(
                        f"slot {d}: joiner crashes before its wiring "
                        f"response at tick {t + 1}")
                creation_order.append(d)
            pending = None

        # -- B: the flushed alert burst lands; H-crossing announces ------
        if pending is not None and pending["announce"] == t:
            emitted = announce_sim(pending["dsts"], t)
            if emitted is None:
                raise ChurnEnvelopeError(
                    f"tick {t}: burst {sorted(pending['dsts'])} never "
                    "emits a proposal (a destination is short of H "
                    "distinct-ring reports or stuck in flux)")
            if emitted != set(pending["dsts"]):
                raise ChurnEnvelopeError(
                    f"tick {t}: the oracle emits a partial proposal "
                    f"{sorted(emitted)} != scheduled "
                    f"{sorted(pending['dsts'])} (mid-batch H-crossing "
                    "with zero in-flux destinations)")
            voters = {m for m in members if alive(m, t)}
            if not voters:
                raise ChurnEnvelopeError(
                    f"tick {t}: no alive member left to announce")
            events.append((t, "proposal",
                           view.get_current_configuration_id(),
                           tuple(sorted(pending["dsts"]))))
            pending["voters"] = voters
            pending["n"] = len(members)

        new_enq: List[Tuple[int, str]] = []

        # -- C: two-phase join gatekeeping (host protocol mirror) --------
        for s in sorted(js):
            st = js[s]
            if st["done"]:
                continue
            p1 = st["start"] + 1  # PreJoin hop: seed evaluates phase 1
            if t == p1:
                if seed_slot not in members:
                    raise ChurnEnvelopeError(
                        f"slot {s}: join seed {seed_slot} is no longer a "
                        f"member at tick {t}")
                if not alive(seed_slot, t) or not alive(seed_slot, t + 1) \
                        or not alive(s, t + 1):
                    raise ChurnEnvelopeError(
                        f"slot {s}: seed or joiner dies during the "
                        f"phase-1 exchange around tick {t}")
                status = view.is_safe_to_join(endpoints[s], st["node_id"])
                if status is JoinStatusCode.HOSTNAME_ALREADY_IN_RING:
                    raise ChurnEnvelopeError(
                        f"slot {s}: endpoint already in the ring at its "
                        f"phase-1 evaluation (tick {t}) — rejoin before "
                        "removal is outside the envelope")
                if status is JoinStatusCode.UUID_ALREADY_IN_RING:
                    st["attempt"] += 1
                    if st["attempt"] > settings.join_attempts:
                        raise ChurnEnvelopeError(
                            f"slot {s}: {settings.join_attempts} join "
                            "attempts exhausted on UUID collisions")
                    st["node_id"] = NodeId(st["rng"].getrandbits(64),
                                           st["rng"].getrandbits(64))
                    st["start"] = t + 1  # retry PreJoin goes out with the reply
                    # The oracle draws the fresh NodeId when the collision
                    # response lands, one hop after this evaluation; the
                    # engine applies the redraw at that tick. Repeat
                    # collisions overwrite: one redraw, final identity.
                    st["redraw"] = t + 1
                    continue
                st["p1_epoch"] = epoch
                st["enq"] = t + 2  # reply hop + JoinMessage hop
            elif st["enq"] == t:
                if epoch != st["p1_epoch"]:
                    raise ChurnEnvelopeError(
                        f"slot {s}: view changed between join phase 1 and "
                        f"the gatekeeper enqueue at tick {t} — the oracle "
                        "answers CONFIG_CHANGED and retries")
                if not alive(s, t):
                    raise ChurnEnvelopeError(
                        f"slot {s}: joiner crashes before its "
                        f"JoinMessages deliver at tick {t}")
                new_enq.append((s, "join"))
            elif st["enq"] is None \
                    and t >= st["start"] + settings.join_timeout_ticks:
                raise ChurnEnvelopeError(
                    f"slot {s}: join attempt times out undecided at "
                    f"tick {t}")

        # -- D: graceful leaves (LeaveMessage hop) -----------------------
        for s, t0 in sorted(leaves.items()):
            if t == t0:
                if s not in members:
                    raise ChurnEnvelopeError(
                        f"slot {s}: leave_gracefully() at tick {t} but the "
                        "slot is not a member")
                if not alive(s, t):
                    raise ChurnEnvelopeError(
                        f"slot {s}: leaver already crashed at its "
                        f"leave_gracefully() tick {t}")
                leave_epochs[s] = epoch  # observers resolved against this view
            elif t == t0 + 1:
                if not alive(s, t):
                    raise ChurnEnvelopeError(
                        f"slot {s}: leaver crashes before its "
                        f"LeaveMessages deliver at tick {t}")
                if leave_epochs.get(s) != epoch:
                    raise ChurnEnvelopeError(
                        f"slot {s}: view changed during the LeaveMessage "
                        f"hop ending at tick {t}")
                new_enq.append((s, "leave"))

        # -- E: failure-detector interval (notify bookkeeping) -----------
        if t % interval == 0 and t > fd_gate:
            for s in sorted(members):
                if alive(s, t) or s in fd_notified:
                    continue
                if fd_cnt.get(s, 0) >= settings.fd_failure_threshold:
                    fd_notified.add(s)
                    new_enq.append((s, "crash"))
                else:
                    fd_cnt[s] = fd_cnt.get(s, 0) + 1

        # -- F: enqueue into the (single) alert pipeline -----------------
        if new_enq:
            if pending is not None:
                non_crash = [(s, k) for s, k in new_enq if k != "crash"]
                if non_crash:
                    raise ChurnEnvelopeError(
                        f"tick {t}: churn alerts {non_crash} enqueued "
                        "while the pipeline deciding at tick "
                        f"{pending['decide']} is in flight — the oracle "
                        "drops and retries them, the single-shot schedule "
                        "cannot")
                # Crash notifications enqueued mid-pipeline are dropped by
                # the decide's reset on both sides; the FD re-notifies
                # after the view change (fd_cnt/fd_notified clear at A).
            else:
                pending = {
                    "enqueue": t,
                    "announce": t + settings.churn_announce_delay_ticks,
                    "decide": t + settings.churn_decide_delay_ticks,
                    "dsts": {s: k for s, k in new_enq},
                }
                for s, kind in new_enq:
                    if kind == "join":
                        schedule.join_tick[s] = t
                        schedule.join_epoch[s] = epoch
                    elif kind == "leave":
                        schedule.leave_tick[s] = t
                        schedule.leave_epoch[s] = epoch

    # Boot fingerprints carry each joiner's *first* attempt; a scheduled
    # redraw swaps in the final identity before anything reads it.
    id_fps = np.zeros(c, np.uint64)
    joiner_ids: Dict[int, NodeId] = {}
    redraws: Dict[int, int] = {}
    for s, st in js.items():
        joiner_ids[s] = st["node_id"]
        if st["redraw"] is not None:
            redraws[s] = st["redraw"]
            id_fps[s] = np.uint64(id_fingerprint(st["first_id"]))
        else:
            id_fps[s] = np.uint64(id_fingerprint(st["node_id"]))
    if redraws:
        by_tick: Dict[int, int] = {}
        for s, rt in redraws.items():
            if rt in by_tick:
                raise ChurnEnvelopeError(
                    f"slots {by_tick[rt]} and {s} both redraw their "
                    f"NodeId at tick {rt} — the engine applies one "
                    "identifier redraw per tick")
            by_tick[rt] = s
        redraw_tick = np.full(c, I32_MAX, np.int32)
        redraw_hi = np.zeros(c, np.uint32)
        redraw_lo = np.zeros(c, np.uint32)
        redraw_idfp_hi = np.zeros(c, np.uint32)
        redraw_idfp_lo = np.zeros(c, np.uint32)
        for s, rt in redraws.items():
            redraw_tick[s] = rt
            # The engine's ring key is the *endpoint* uid, which a NodeId
            # redraw does not move — so the scripted replacement limbs
            # equal the boot limbs and rank_and_insert lands the slot back
            # on its own position. The fingerprint swap is the real work.
            redraw_hi[s], redraw_lo[s] = hashing.to_limbs(
                uid_of(endpoints[s]))
            redraw_idfp_hi[s], redraw_idfp_lo[s] = hashing.to_limbs(
                id_fingerprint(js[s]["node_id"]))
        schedule = schedule._replace(
            redraw_tick=redraw_tick, redraw_hi=redraw_hi,
            redraw_lo=redraw_lo, redraw_idfp_hi=redraw_idfp_hi,
            redraw_idfp_lo=redraw_idfp_lo)

    return ChurnPlan(
        schedule=schedule,
        id_fps=id_fps,
        joiner_ids=joiner_ids,
        wired=wired,
        events=events,
        final_members=frozenset(members),
        final_config_id=view.get_current_configuration_id(),
        redraws=redraws,
    )


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
