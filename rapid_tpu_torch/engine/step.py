"""The shared-state tick engine: one view stands in for every receiver.

Exact for crash faults: every alive receiver sees the same alert stream,
so one cut detector and one fast round serve them all. Link windows and
probe drop perturb the failure detector's probes only. Phase order
inside a tick mirrors the reference's ``rapid_tpu.engine.step``:

0. **classic chain** (with a fallback schedule): phase-2b, 2a and 1b
   messages land, then the scripted fast-round votes are tallied; a
   classic majority or a scripted fast quorum decides;
1. **decide**: fast-round votes sent at the announce tick arrive; a
   quorum (or the scripted instance) triggers the view change
   (membership XOR with the decided mask, 64-bit member and identifier
   sums, the sort-free topology rebuild, the reset of monitor, cut and
   consensus state, an epoch increment); then phase-1a broadcasts land;
2. **deliver**: alert batches flushed last tick (monitor DOWNs, and the
   churn pipeline's leave-DOWNs and join-UPs) land in the cut detector;
   an H-crossing with no destination in flux announces the proposal and
   casts the votes;
3. **flush**: batches enqueued last tick move to delivery;
4. **churn, monitor, tasks**: scheduled identifier redraws (4a′) and
   join/leave alerts whose epoch still holds (4a); on ticks
   ``t % fd_interval_ticks == 0`` past ``fd_gate`` every node probes its
   subjects (4b); scripted proposes and fallback-timer fires (4c).

Where the reference lowers one ``lax.scan`` with ``lax.cond`` and a
``lax.while_loop``, the port runs eagerly: the tick is a host int, and
the data-dependent branches read 0-d tensors on the host
(``device.read_host``). ``cut.aggregate`` reads once whether the tick
announces; votes arrive exactly one tick after an announce, so
``simulate`` carries that read into the next tick. A tick with arriving
votes, or one on which a classic round can decide, reads once more
whether it decides. The host also carries the epoch (it changes only at
a decide), the member count, the config-id limbs, and host copies of the
schedules, read once per run. What a branch skips is provably what the
reference computes and then masks away:

- the vote count, on ticks when no votes arrive;
- the view change, on ticks that do not decide (``lax.cond``);
- the proposal fingerprint and the announce updates, on ticks that do
  not announce;
- ``monitor_tick`` when ``t % fd_interval_ticks != 0``; its other half,
  ``t > fd_gate``, is on the device and stays a ``torch.where``;
- churn deliveries two ticks after no injection tick, injections off the
  schedule's join and leave ticks, redraws off its redraw ticks;
- every fallback phase while no scripted instance is live, and each one
  off the ticks ``paxos.FallbackTicks`` allows. The scripted fast
  round's tally changes only when a vote arrives, so it is computed (and
  whether it reaches the quorum read) once per arrival tick.

``Settings.protocol_variant`` picks the vote tally and the message
factors: "rapid" and "ring" the segmented tally, "ring" with its two-lap
factors (``variants.ring``; its permutation round trip is the identity
on values), "hier" the group quorums (``variants.hier``, the groups
hashed once on a tick that needs them); each branch runs only under its
variant. With
``invariant_checks`` every tick packs ``invariants.check_step`` into
``inv_bits`` (else the constant 0); with ``flight_recorder_window > 0``
``simulate`` also returns the run's ``recorder.RecorderState``. A device
mesh raises ``NotImplementedError`` (``ROADMAP.md`` Queue 1 item 8).

``fleet_body`` runs a stacked fleet (``engine.fleet``): F members, the
member axis first on every tensor, through one host loop. ``_FleetHost``
keeps ``_Host``'s knowledge per member (epochs, arrivals, member counts,
config ids, the fallback schedules' tick sets), a phase runs when any
member needs it, as one batched call (``state.member_map``) or the plain
op where it broadcasts, and its result is kept where a ``[F]`` mask says
the member's own ``_step`` would have run it. Each read returns a
``[F]`` vector in one transfer, so host reads and launches per tick do
not grow with F.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from rapid_tpu_torch import hashing
from rapid_tpu_torch.device import read_arrays, read_host, resolve_device
from rapid_tpu_torch.engine import churn as churn_mod
from rapid_tpu_torch.engine import (cut, invariants, monitor, paxos,
                                    recorder, votes)
from rapid_tpu_torch.engine.state import (
    I32_MAX, EngineFaults, EngineState, StepLog, config_id_limbs, member_map)
from rapid_tpu_torch.engine.topology import build_topology
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.variants import hier, ring

#: The classic-Paxos message factors of ``StepLog``.
PX_COUNTS = ("pxvote_senders", "pxvote_recipients", "px1a_senders",
             "px1a_recipients", "px1b_senders", "px2a_senders",
             "px2a_recipients", "px2b_senders", "px2b_recipients")


def require_scope(mesh=None) -> None:
    """Refuse what the shared engine's port does not run yet."""
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh: sharding is ROADMAP.md Queue 1 item 8; the "
            "shared engine's port does not run it yet")


class _Host:
    """What the host knows of a run between its ticks."""

    def __init__(self, state: EngineState, churn, fallback):
        arrays = [state.tick, state.epoch]
        if churn is not None:
            arrays += [churn.join_tick, churn.leave_tick]
            if churn.redraw_tick is not None:
                arrays.append(churn.redraw_tick)
        if fallback is not None:
            arrays += [fallback.prop_tick, fallback.prop_pid,
                       fallback.prop_delay, fallback.inst_epoch]
        got = read_arrays(*arrays)
        self.tick, self.epoch = int(got[0]), int(got[1])
        self.start = self.tick
        self.config = None      # config-id limbs of the state's sums
        self.arriving = None    # fast-round votes arrive next tick
        self.n_member = None    # the state's member count (0-d int32)
        self.px_gauges = None   # (px_timers_armed, px_coord_round)
        self.tally = {}         # (epoch, arrivals) -> scripted fast round
        at = 2
        if churn is not None:
            self.inject_ticks = set(got[2].tolist()) | set(got[3].tolist())
            self.redraw_ticks = (set(got[4].tolist())
                                 if churn.redraw_tick is not None else set())
            at += 2 + (churn.redraw_tick is not None)
        if fallback is not None:
            self.fb = paxos.FallbackTicks(*got[at:at + 4])

    def churn_may_deliver(self, t: int) -> bool:
        """Alerts injected at tick ``i`` flush at ``i + 1`` and land at
        ``i + 2``; a run's first two ticks may land what its state holds."""
        return t - 2 in self.inject_ticks or t <= self.start + 2


def _view_change(state: EngineState, pmask, with_pos: bool):
    """The decided view: member XOR ``pmask``, the 64-bit sums, the
    topology rebuilt from the static ring order, and (with a fallback
    schedule) the ring-0 positions."""
    removed = (pmask & state.member).to(torch.int64)
    joined = (pmask & ~state.member).to(torch.int64)
    member = state.member ^ pmask
    rhi, rlo = hashing.sum64_axis(state.mfp_hi * removed,
                                  state.mfp_lo * removed)
    ahi, alo = hashing.sum64_axis(state.mfp_hi * joined,
                                  state.mfp_lo * joined)
    ms_hi, ms_lo = hashing.sub64(state.memsum_hi, state.memsum_lo, rhi, rlo)
    ms_hi, ms_lo = hashing.add64(ms_hi, ms_lo, ahi, alo)
    # Identifiers are remembered forever: joins add, removals never
    # subtract.
    ihi, ilo = hashing.sum64_axis(state.idfp_hi * joined,
                                  state.idfp_lo * joined)
    id_hi, id_lo = hashing.add64(state.idsum_hi, state.idsum_lo, ihi, ilo)
    subj, obs, gk, fd_active, fd_first = build_topology(
        member, state.ring_order, state.ring_rank)
    out = dict(member=member, memsum_hi=ms_hi, memsum_lo=ms_lo,
               idsum_hi=id_hi, idsum_lo=id_lo, subj_idx=subj, obs_idx=obs,
               gk_idx=gk, fd_active=fd_active, fd_first=fd_first)
    if with_pos:
        out["px_pos"] = paxos.ring0_positions(member, state.ring_order,
                                              state.ring_rank)
    return out


def _px_resets(state: EngineState) -> dict:
    """A decision replaces the consensus instance: ranks back to zero,
    chosen values cleared, every timer and the classic chain dropped."""
    zero = torch.zeros_like(state.px_rnd_r)
    none = torch.full_like(state.px_vval, -1)
    never = torch.full_like(state.c1a_tick, I32_MAX)
    return dict(
        px_rnd_r=zero, px_rnd_i=zero, px_vrnd_r=zero, px_vrnd_i=zero,
        px_vval=none, px_crnd_r=zero, px_crnd_i=zero, px_cval=none,
        px_timer=torch.full_like(state.px_timer, I32_MAX),
        c1a_tick=never, c1b_tick=never, c2a_tick=never, c2b_tick=never,
        c1b_mask=torch.zeros_like(state.c1b_mask))


def _scripted_round(state, fallback, host: _Host, e: int, t: int, n):
    """Phase 0 on a live tick: ``(state, counts, sc, sc_known, sc_pid,
    tally)``. ``sc`` (0-d bool, or None when provably false) says whether
    the scripted instance decides; ``sc_known`` is its host value when
    that is known without a read, else None."""
    fb = host.fb
    counts = {}
    classic = classic_pid = None
    if fb.fired_before(e, t, 2, 3, 4):
        state, counts, classic, classic_pid = paxos.chain_deliver(
            state, fallback, t, n)
        if not fb.fired_before(e, t, 4):
            classic = None      # no phase 2b can land this tick
    ok = win_pid = None
    tally = torch.zeros_like(n)
    arrived = fb.arrived(e, t)
    if arrived:
        key = (host.epoch, arrived)
        if key not in host.tally:
            host.tally = {key: paxos.fast_tally(state, fallback, e, t, n)}
            entry = host.tally[key]
            host.tally[key] = entry + tuple(read_host(entry[0]))
        ok, win_pid, tally, _, ok_host = host.tally[key]
        if not ok_host:
            ok = None
    if classic is not None:
        # classic | (ok & ~classic): the fast round is blocked by a
        # classic decide earlier in the same tick.
        sc = classic if ok is None else classic | ok
        pid = classic_pid if ok is None else torch.where(classic,
                                                         classic_pid,
                                                         win_pid)
        return state, counts, sc, None, pid, tally
    if ok is not None:
        return state, counts, ok, True, win_pid, tally
    return state, counts, None, False, None, tally


def step(state: EngineState, faults: EngineFaults, settings: Settings,
         churn=None, fallback=None, mesh=None, *, tick: Optional[int] = None):
    """Advance the shared engine by one tick; returns ``(state, log)``.

    ``churn`` is a ``churn.ChurnSchedule`` and ``fallback`` a
    ``paxos.FallbackSchedule`` of tensors on the state's device, or None.
    ``tick`` is ``state.tick`` as a host int, read from the state when
    omitted (the state's epoch and the schedules are read all the same).
    """
    require_scope(mesh)
    host = _Host(state, churn, fallback)
    if tick is not None:
        host.tick = int(tick)
    new, log = _step(state, faults, settings, host, churn, fallback)
    return new, log


def _step(state: EngineState, faults: EngineFaults, settings: Settings,
          host: _Host, churn=None, fallback=None):
    """One tick ``t = host.tick + 1``; returns ``(state, log)`` and
    advances ``host`` past it."""
    t = host.tick + 1
    dev = state.member.device
    c = state.member.shape[0]
    variant = settings.protocol_variant
    n_groups, gid = hier.hier_group_count(c), None
    i32 = lambda x: x.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    no_slots = lambda: torch.zeros(c, dtype=torch.bool, device=dev)
    crashed = monitor.crashed_at(faults, t)
    tick_t = state.tick + 1
    if host.n_member is None:
        host.n_member = i32(state.member.sum())
    n_member = host.n_member
    px = {}

    # ---- phase 0: classic-chain deliveries and the scripted fast round
    sc, sc_known, sc_pid, px_tally = None, False, None, zero
    if fallback is not None:
        e, live = host.fb.row(host.epoch)
        if live:
            state, px, sc, sc_known, sc_pid, px_tally = _scripted_round(
                state, fallback, host, e, t, n_member)

    # ---- phase 1: vote delivery and decision --------------------------
    votes_arriving = state.vote_pending & (state.announce_tick + 1 == t)
    arriving = host.arriving
    if arriving is None:
        (arriving,) = read_host(votes_arriving)
    alert = None
    vote_tally = vote_quorum = vote_senders_alive = vote_deliver_alive = zero
    vote_pending = state.vote_pending
    if arriving:
        alive_members = state.member & ~crashed
        valid = state.voters & ~crashed
        if variant == "hier":
            gid = hier.group_ids(state.uid_hi, state.uid_lo, n_groups)
            decided, vote_tally = hier.hier_count_fast_round(
                state.member, valid, gid, n_groups)
        else:
            decided, vote_tally = votes.count_fast_round(
                state.phash_hi.expand(c), state.phash_lo.expand(c), valid,
                n_member)
        vote_quorum = votes.fast_quorum(n_member)
        # A decision needs an alive receiver to count the votes, and a
        # scripted decide this tick takes precedence.
        alert = decided & alive_members.any()
        if sc is not None:
            alert = alert & ~sc
        # Vote delivery factors: every vote to every alive member; the
        # ring's two laps; hier's whole exchange as one factor, recipient 1.
        if variant == "hier":
            gate = valid.any() & alive_members.any()
            vote_senders_alive = torch.where(
                gate, hier.hier_exchange_messages(
                    valid, alive_members, gid, n_groups), zero)
            vote_deliver_alive = i32(gate)
        else:
            vote_senders_alive = (ring.ring_pair_factor(valid)
                                  if variant == "ring"
                                  else i32(valid.sum()))
            vote_deliver_alive = i32(alive_members.sum())
        vote_pending = vote_pending & ~votes_arriving
    if fallback is not None:
        vote_tally = torch.maximum(vote_tally, px_tally)
        vote_quorum = torch.maximum(vote_quorum, votes.fast_quorum(n_member))

    # One read settles whatever the host does not know yet.
    ask = []
    if alert is not None and sc_known is not True:
        ask.append(alert)
    if sc is not None and sc_known is None:
        ask.append(sc)
    got = read_host(*ask) if ask else []
    alert_decide = bool(got[0]) if alert is not None and \
        sc_known is not True else False
    sc_decide = bool(got[-1]) if sc is not None and sc_known is None \
        else bool(sc_known)
    decide = alert_decide or sc_decide
    flags = [f for f in (alert, sc) if f is not None]
    decide_now = (flags[0] | flags[1] if len(flags) == 2 else flags[0]) \
        if flags else torch.zeros((), dtype=torch.bool, device=dev)

    if decide:
        if sc_decide:
            n_pids = fallback.table_mask.shape[1]
            pmask = fallback.table_mask[host.fb.row(host.epoch)[0]][
                sc_pid.clamp(0, n_pids - 1).long()]
        else:
            pmask = state.proposal
        ck_false = torch.zeros_like(state.reports)
        mid = state._replace(
            tick=tick_t,
            **_view_change(state, pmask, fallback is not None),
            fc=torch.zeros_like(state.fc), notified=ck_false,
            fd_gate=tick_t, pending_flush=ck_false,
            pending_deliver=ck_false,
            churn_flush=no_slots(), churn_deliver=no_slots(),
            reports=ck_false, seen_down=torch.zeros_like(decide_now),
            announced=torch.zeros_like(decide_now), proposal=no_slots(),
            vote_pending=vote_pending, voters=no_slots(),
            epoch=state.epoch + 1,
            **(_px_resets(state) if fallback is not None else {}))
        decision = pmask
        host.epoch += 1
        host.n_member = n_member = i32(mid.member.sum())
        host.px_gauges = None
    else:
        mid = state._replace(tick=tick_t, vote_pending=vote_pending)
        decision = no_slots()

    # ---- phase 1b: late phase-1a delivery (a task-phase send) ----------
    if fallback is not None and not decide:
        e, live = host.fb.row(host.epoch)
        if live and host.fb.fired_before(e, t, 1):
            mid, px["px1b_senders"] = paxos.phase1a_deliver(mid, t)

    # ---- phase 2: alert delivery, aggregation, announce ----------------
    src_alive = ~crashed
    batch_src = mid.pending_deliver.any(dim=1)
    n_alive = i32((mid.member & src_alive).sum())
    flushers_alive = (ring.ring_pair_factor(batch_src & src_alive)
                      if variant == "ring"
                      else i32((batch_src & src_alive).sum()))
    delivered_down = cut.deliver_reports(mid, src_alive)
    delivered_up = None
    if churn is not None and host.churn_may_deliver(t):
        churn_down, delivered_up = cut.deliver_churn_reports(mid, src_alive)
        delivered_down = delivered_down | churn_down
    (reports, seen_down, announce_now, crossed, _explicit,
     implicit_added, announce) = cut.aggregate(
        mid, delivered_down, delivered_up, n_alive > 0, settings)
    mid = mid._replace(reports=reports, seen_down=seen_down)
    if announce:
        ph_hi, ph_lo = votes.proposal_fingerprint(crossed, mid.uid_hi,
                                                  mid.uid_lo)
        mid = mid._replace(
            announced=mid.announced | announce_now, proposal=crossed,
            announce_tick=tick_t,
            vote_pending=mid.vote_pending | announce_now,
            voters=mid.member & src_alive, phash_hi=ph_hi, phash_lo=ph_lo)
    n_member_now = n_member
    vote_senders = n_alive if announce else zero
    vote_recipients = n_member_now if announce else zero
    if announce and variant == "ring":
        vote_senders = torch.full_like(zero, 2)
    elif announce and variant == "hier":
        if gid is None:
            gid = hier.group_ids(mid.uid_hi, mid.uid_lo, n_groups)
        vote_senders = hier.hier_exchange_messages(
            mid.member & src_alive, mid.member, gid, n_groups)
        vote_recipients = torch.ones_like(zero)

    # ---- phase 3: batch flush (1-tick quiescence) ----------------------
    flusher_mask = mid.pending_flush.any(dim=1)
    flushers = (ring.ring_pair_factor(flusher_mask) if variant == "ring"
                else i32(flusher_mask.sum()))
    flush_recipients = torch.where(flusher_mask.any(), n_member_now, zero)
    mid = mid._replace(pending_deliver=mid.pending_flush,
                       pending_flush=torch.zeros_like(mid.pending_flush),
                       churn_deliver=mid.churn_flush,
                       churn_flush=torch.zeros_like(mid.churn_flush))

    # ---- phase 4a': scripted identifier redraws ------------------------
    if churn is not None and t in host.redraw_ticks:
        redraw_now = (churn.redraw_tick == t) & ~mid.member
        any_redraw, slot = read_host(redraw_now.any(),
                                     torch.argmax(redraw_now.to(torch.uint8)))
        if any_redraw:
            mid = churn_mod.apply_redraws(mid, churn, slot)

    # ---- phase 4a: churn alert injection -------------------------------
    churn_injected = zero
    if churn is not None and t in host.inject_ticks:
        flush, churn_injected = churn_mod.inject(mid, churn, t)
        mid = mid._replace(churn_flush=flush)

    # ---- phase 4b: failure-detector interval ---------------------------
    probes_sent = probes_failed = zero
    new = mid
    if t % settings.fd_interval_ticks == 0:
        is_fd = t > mid.fd_gate
        fc, notified, notify_exp, sent, failed = monitor.monitor_tick(
            mid, faults, settings, t)
        new = mid._replace(fc=torch.where(is_fd, fc, mid.fc),
                           notified=torch.where(is_fd, notified,
                                                mid.notified),
                           pending_flush=notify_exp & is_fd)
        probes_sent = torch.where(is_fd, sent, zero)
        probes_failed = torch.where(is_fd, failed, zero)

    # ---- phase 4c: scripted proposes and fallback-timer fires ----------
    px_timers_armed = px_coord_round = zero
    if fallback is not None:
        e, live = host.fb.row(host.epoch)
        send = live and t in host.fb.send[e]
        fire = live and not decide and t in host.fb.fire[e]
        if send or fire:
            new, task_counts = paxos.task_phase(new, fallback, e, t,
                                                n_member_now, send, fire)
            px.update(task_counts)
            host.px_gauges = None
        if host.px_gauges is None:
            host.px_gauges = (i32((new.px_timer != I32_MAX).sum()),
                              new.px_crnd_r.max())
        px_timers_armed, px_coord_round = host.px_gauges
    if variant == "ring" and "pxvote_senders" in px:
        # The scripted fast-round votes ride the ring's two laps too.
        px["pxvote_senders"] = ring.ring_pair_factor(
            px["pxvote_senders"] > 0)

    inv_bits = zero
    if settings.invariant_checks:
        false = torch.zeros((), dtype=torch.bool, device=dev)
        inv_bits = invariants.check_step(
            state, new, decide_now=decide_now,
            fast_decide=false if alert is None else alert,
            classic_decide=false if sc is None else sc,
            fast_mask=state.proposal,
            classic_mask=pmask if sc_decide else no_slots(),
            settings=settings)

    if decide or host.config is None:
        host.config = config_id_limbs(new.idsum_hi, new.idsum_lo,
                                      new.memsum_hi, new.memsum_lo)
    cfg_hi, cfg_lo = host.config
    alerts_in_flight = i32(
        new.pending_flush.any(dim=1).sum()
        + new.pending_deliver.any(dim=1).sum()
        + new.churn_flush.sum() + new.churn_deliver.sum())
    log = StepLog(
        tick=tick_t,
        announce_now=announce_now,
        proposal=crossed if announce else no_slots(),
        decide_now=decide_now,
        decision=decision,
        config_hi=cfg_hi, config_lo=cfg_lo,
        n_member=n_member_now,
        probes_sent=probes_sent, probes_failed=probes_failed,
        flushers=flushers, flush_recipients=flush_recipients,
        flushers_alive=flushers_alive,
        deliver_alive=torch.where(batch_src.any(), n_alive, zero),
        vote_senders=vote_senders, vote_recipients=vote_recipients,
        vote_senders_alive=vote_senders_alive,
        vote_deliver_alive=vote_deliver_alive,
        alerts_in_flight=alerts_in_flight,
        cut_reports=i32(new.reports.sum()),
        implicit_reports=implicit_added,
        vote_tally=vote_tally, quorum=vote_quorum,
        epoch=new.epoch,
        churn_injected=churn_injected,
        partitioned_edges=monitor.partitioned_edge_count(faults, new.member,
                                                         t),
        link_dropped=zero,
        px_timers_armed=px_timers_armed, px_coord_round=px_coord_round,
        inv_bits=inv_bits,
        **{name: px.get(name, zero) for name in PX_COUNTS},
    )
    host.tick = t
    host.arriving = announce
    return new, log


def stack_logs(logs: List[StepLog]) -> StepLog:
    """Per-tick logs -> one log with a leading tick axis."""
    return StepLog(*[torch.stack(f) for f in zip(*logs)])


def simulate(state: EngineState, faults: EngineFaults, n_ticks: int,
             settings: Settings, churn=None, fallback=None, mesh=None,
             device="cuda"):
    """Run ``n_ticks`` shared-engine steps on ``device``, where ``state``,
    ``faults`` and the schedules must live; returns ``(final, logs)``
    with every ``StepLog`` field stacked on a leading tick axis, as the
    reference's ``lax.scan`` gives them, and with
    ``settings.flight_recorder_window > 0`` ``(final, logs, recorder)``.
    ``churn`` is a ``churn.ChurnSchedule`` and ``fallback`` a
    ``paxos.FallbackSchedule`` of tensors (``convert.from_reference``
    moves a host schedule), or None."""
    return _simulate(state, faults, n_ticks, settings, churn, fallback,
                     mesh, device, None)


def _simulate(state, faults, n_ticks: int, settings: Settings, churn,
              fallback, mesh, device, rec):
    """``simulate``, folding the logs into the recorder ``rec`` when one
    is given (``simulate_chunk``) and into a fresh one otherwise."""
    require_scope(mesh)
    dev = resolve_device(device)
    placed = [("state", state.member.device),
              ("faults", faults.crash_tick.device)]
    if churn is not None:
        placed.append(("churn schedule", churn.join_tick.device))
    if fallback is not None:
        placed.append(("fallback schedule", fallback.prop_tick.device))
    for name, where in placed:
        if where.type != dev.type:
            raise ValueError(f"{name} lives on {where}, the run was asked "
                             f"for {dev}")
    host = _Host(state, churn, fallback)
    logs = []
    for _ in range(int(n_ticks)):
        state, log = _step(state, faults, settings, host, churn, fallback)
        logs.append(log)
    logs = stack_logs(logs)
    if settings.flight_recorder_window:
        if rec is None:
            rec = recorder.init(settings, device=dev)
        return state, logs, recorder.record_run(rec, logs, settings)
    return state, logs


def simulate_chunk(state: EngineState, faults: EngineFaults, n_ticks: int,
                   settings: Settings, churn=None, fallback=None, mesh=None,
                   rec=None, donate: bool = True, device="cuda"):
    """One streaming chunk: ``n_ticks`` steps from an arbitrary carry, as
    the resident service (``rapid_tpu_torch.service.resident``) chains
    them. The same as ``simulate``, but the flight recorder resumes from
    ``rec`` when given (needed for every chunk after the first when
    ``settings.flight_recorder_window > 0``). Chained chunks equal one
    uninterrupted ``simulate`` of the summed length: each chunk rebuilds
    the host's knowledge (``_Host``: the epoch, the member count, the
    config id, whether votes arrive on its first tick) from the state it
    is given, as a fresh ``simulate`` does, so a boundary between an
    announce and its decide changes nothing.

    ``donate`` is accepted so the reference's callers port unchanged.
    PyTorch has no donation: every step builds new tensors and leaves its
    inputs intact, so ``donate=False`` needs no copy, and the old carry
    is freed when the caller drops it (the service's live-buffer
    watermark holds that)."""
    del donate
    return _simulate(state, faults, n_ticks, settings, churn, fallback,
                     mesh, device, rec)


# ---------------------------------------------------------------------------
# fleets: F clusters through one host loop and one set of launches a tick
# ---------------------------------------------------------------------------


def _merge(mask, new, old):
    """``new`` where the ``[F]`` bool ``mask`` holds, else ``old``, field
    by field; fields ``new`` shares with ``old`` are kept as they are."""
    def pick(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)),
                           a, b)

    return old._replace(**{f: pick(a, b) for f, a, b in
                           zip(old._fields, new, old) if a is not b})


class _FleetTicks:
    """``paxos.FallbackTicks`` of every member, with the union of their
    tick sets so that a tick on which no member can act is passed over
    without a loop over the members."""

    def __init__(self, prop_tick, prop_pid, prop_delay, inst_epoch):
        self.inst_epoch = np.asarray(inst_epoch)
        self.per = [paxos.FallbackTicks(*rows) for rows in zip(
            prop_tick, prop_pid, prop_delay, self.inst_epoch)]
        self.fire_any = set().union(*(s for fb in self.per for s in fb.fire))
        self.send_any = set().union(*(s for fb in self.per for s in fb.send))
        self.arrive_any = set().union(*(a.tolist() for fb in self.per
                                        for a in fb.arrivals))
        self._arrived = None      # (epochs, t, counts) of the last call

    def rows(self, epoch):
        """``(e, live)``: each member's schedule row and whether its
        instance is live, as ``[F]`` numpy arrays."""
        e = np.clip(epoch, 0, self.inst_epoch.shape[1] - 1)
        return e, self.inst_epoch[np.arange(len(e)), e] == epoch

    def fired(self, e, live, t: int, *lags: int):
        """bool ``[F]``: a timer of the member's row fired ``lag`` ticks
        before ``t`` for one of ``lags``."""
        if not any(t - lag in self.fire_any for lag in lags):
            return np.zeros(len(e), bool)
        return live & np.array([fb.fired_before(int(r), t, *lags)
                                for fb, r in zip(self.per, e)])

    def sends(self, e, live, t: int):
        if t not in self.send_any:
            return np.zeros(len(e), bool)
        return live & np.array([t in fb.send[int(r)]
                                for fb, r in zip(self.per, e)])

    def fires(self, e, live, t: int):
        if t not in self.fire_any:
            return np.zeros(len(e), bool)
        return live & np.array([t in fb.fire[int(r)]
                                for fb, r in zip(self.per, e)])

    def arrived(self, epoch, t: int):
        """int ``[F]``: ``FallbackTicks.arrived`` of each live member (0
        for the others); it changes only at an arrival tick or with an
        epoch."""
        last = self._arrived
        if last is not None and np.array_equal(last[0], epoch) and \
                not any(last[1] < a <= t for a in self.arrive_any):
            return last[2]
        e, live = self.rows(epoch)
        counts = np.array([fb.arrived(int(r), t) if ok else 0
                           for fb, r, ok in zip(self.per, e, live)])
        self._arrived = (epoch.copy(), t, counts)
        return counts


class _FleetHost:
    """What the host knows of a fleet run between its ticks: ``_Host``
    per member. Epochs and vote arrivals are ``[F]`` numpy arrays; the
    member counts, config-id limbs and Paxos gauges ``[F]`` tensors; each
    read returns one ``[F]`` vector in the one transfer it already is."""

    def __init__(self, state: EngineState, churn, fallback):
        got = read_arrays(state.tick, state.epoch, churn.join_tick,
                          churn.leave_tick, fallback.prop_tick,
                          fallback.prop_pid, fallback.prop_delay,
                          fallback.inst_epoch)
        if len(set(got[0].tolist())) != 1:
            raise ValueError("fleet members must start at one tick")
        self.dev = state.member.device
        self.tick = int(got[0][0])
        self.start = self.tick
        self.epoch = got[1].astype(np.int64)
        self.inject_ticks = set(got[2].ravel().tolist()) | set(
            got[3].ravel().tolist())
        self.fb = _FleetTicks(*got[4:8])
        self.arriving = None    # bool [F]: fast-round votes arrive next tick
        self.n_member = None    # i32 [F]
        self.config = None      # config-id limbs, [F] each
        self.px_gauges = None   # (px_timers_armed, px_coord_round), [F]
        self.tally = None       # (keys, ok, win_pid, tally) of the last tally
        self._rows = None       # (epochs, per-member schedule rows)

    def put(self, mask):
        """A host ``[F]`` mask on the run's device (no wait for the
        queued work)."""
        return torch.from_numpy(np.ascontiguousarray(mask)).to(
            self.dev, non_blocking=True)

    def fallback_rows(self, fallback, state):
        """Each member's live-instance row of ``fallback`` as a
        one-instance schedule (leaves ``[F, 1, ...]``), gathered by the
        device epochs, which equal ``self.epoch``."""
        if self._rows is None or not np.array_equal(self._rows[0],
                                                    self.epoch):
            e = torch.clamp(state.epoch.long(), 0,
                            fallback.inst_epoch.shape[1] - 1)
            at = torch.arange(e.shape[0], device=e.device)
            self._rows = (self.epoch.copy(), paxos.FallbackSchedule(
                *[leaf[at, e][:, None] for leaf in fallback]))
        return self._rows[1]


def _fleet_step(state: EngineState, faults: EngineFaults, settings: Settings,
                host: _FleetHost, churn, fallback):
    """One tick of every member, the member axis first on every tensor.

    Each phase of ``_step`` runs when any member needs it: the host's
    condition for one member becomes a ``[F]`` mask, the phase runs for
    all members (``member_map``, or the plain op where it broadcasts),
    and its result is taken where the mask holds. A member therefore
    gets exactly its own ``_step``, and the reference's ``vmap`` of its
    ``lax.cond``s, by construction.
    """
    t = host.tick + 1
    dev = state.member.device
    f, c = state.member.shape
    variant = settings.protocol_variant
    n_groups, gid = hier.hier_group_count(c), None
    i32 = lambda x: x.to(torch.int32)
    zero = torch.zeros(f, dtype=torch.int32, device=dev)
    no_slots = lambda: torch.zeros((f, c), dtype=torch.bool, device=dev)
    where = lambda m, a, b: torch.where(
        m.reshape(m.shape + (1,) * (a.dim() - 1)), a, b)
    crashed = monitor.crashed_at(faults, t)
    tick_t = state.tick + 1
    if host.n_member is None:
        host.n_member = i32(state.member.sum(dim=-1))
    n_member = host.n_member
    fb = host.fb
    px = {}

    # ---- phase 0: classic-chain deliveries and the scripted fast round
    sc = sc_pid = None
    px_tally = zero
    e, live = fb.rows(host.epoch)
    rows = host.fallback_rows(fallback, state)
    chain = fb.fired(e, live, t, 2, 3, 4)
    if chain.any():
        m = host.put(chain)
        new, counts, classic, classic_pid = member_map(
            lambda s, r, n: paxos.chain_deliver(s, r, t, n), state, rows,
            n_member)
        state = _merge(m, new, state)
        px = {k: torch.where(m, v, zero) for k, v in counts.items()}
        sc = classic & host.put(fb.fired(e, live, t, 4))
        sc_pid = classic_pid
    arrived = fb.arrived(host.epoch, t)
    if arrived.any():
        keys = np.stack([host.epoch, arrived])
        if host.tally is None or not np.array_equal(host.tally[0], keys):
            # A member's tally is a function of its key alone, so all
            # members are recomputed when any key moves.
            host.tally = (keys,) + member_map(
                lambda s, r, n: paxos.fast_tally(s, r, 0, t, n)[:3],
                state, rows, n_member)
        _, ok, win_pid, tally = host.tally
        am = host.put(arrived > 0)
        ok = ok & am
        px_tally = torch.where(am, tally, zero)
        if sc is None:
            sc, sc_pid = ok, win_pid
        else:
            sc_pid = torch.where(sc, sc_pid, win_pid)
            sc = sc | ok

    # ---- phase 1: vote delivery and decision --------------------------
    votes_arriving = state.vote_pending & (state.announce_tick + 1 == t)
    arriving = host.arriving
    if arriving is None:
        arriving = read_arrays(votes_arriving)[0].astype(bool)
    alert = None
    vote_tally = vote_quorum = vote_senders_alive = vote_deliver_alive = zero
    vote_pending = state.vote_pending
    if arriving.any():
        va = votes_arriving
        alive_members = state.member & ~crashed
        valid = state.voters & ~crashed
        if variant == "hier":
            gid = member_map(lambda hi, lo: hier.group_ids(hi, lo, n_groups),
                             state.uid_hi, state.uid_lo)
            decided, tally = member_map(
                lambda m, v, g: hier.hier_count_fast_round(m, v, g,
                                                           n_groups),
                state.member, valid, gid)
        else:
            decided, tally = member_map(
                lambda hi, lo, v, n: votes.count_fast_round(
                    hi.expand(c), lo.expand(c), v, n),
                state.phash_hi, state.phash_lo, valid, n_member)
        vote_tally = torch.where(va, tally, zero)
        vote_quorum = torch.where(va, votes.fast_quorum(n_member), zero)
        alert = decided & alive_members.any(dim=-1) & va
        if sc is not None:
            alert = alert & ~sc
        if variant == "hier":
            gate = valid.any(dim=-1) & alive_members.any(dim=-1)
            senders = torch.where(gate, member_map(
                lambda v, a, g: hier.hier_exchange_messages(v, a, g,
                                                            n_groups),
                valid, alive_members, gid), zero)
            recipients = i32(gate)
        else:
            senders = (ring.ring_pair_factor(valid) if variant == "ring"
                       else i32(valid.sum(dim=-1)))
            recipients = i32(alive_members.sum(dim=-1))
        vote_senders_alive = torch.where(va, senders, zero)
        vote_deliver_alive = torch.where(va, recipients, zero)
        vote_pending = vote_pending & ~votes_arriving
    vote_tally = torch.maximum(vote_tally, px_tally)
    vote_quorum = torch.maximum(vote_quorum, votes.fast_quorum(n_member))

    # One read settles which members decide.
    false = torch.zeros(f, dtype=torch.bool, device=dev)
    fast = false if alert is None else alert
    classic = false if sc is None else sc
    decide_now = fast | classic
    decide = (read_arrays(decide_now)[0].astype(bool)
              if alert is not None or sc is not None
              else np.zeros(f, bool))
    pmask = state.proposal

    if decide.any():
        if sc is not None:
            n_pids = rows.table_mask.shape[2]
            pick = rows.table_mask[:, 0][torch.arange(f, device=dev),
                                         sc_pid.clamp(0, n_pids - 1).long()]
            pmask = torch.where(sc[:, None], pick, state.proposal)
        ck_false = torch.zeros_like(state.reports)
        decided_state = state._replace(
            tick=tick_t,
            **member_map(lambda s, p: _view_change(s, p, True), state,
                         pmask),
            fc=torch.zeros_like(state.fc), notified=ck_false,
            fd_gate=tick_t, pending_flush=ck_false,
            pending_deliver=ck_false,
            churn_flush=no_slots(), churn_deliver=no_slots(),
            reports=ck_false, seen_down=false, announced=false,
            proposal=no_slots(), vote_pending=vote_pending,
            voters=no_slots(), epoch=state.epoch + 1, **_px_resets(state))
        mid = _merge(decide_now, decided_state,
                     state._replace(tick=tick_t, vote_pending=vote_pending))
        decision = pmask & decide_now[:, None]
        host.epoch = host.epoch + decide
        host.n_member = n_member = torch.where(
            decide_now, i32(mid.member.sum(dim=-1)), n_member)
        host.px_gauges = None
        e, live = fb.rows(host.epoch)
        rows = host.fallback_rows(fallback, mid)
    else:
        mid = state._replace(tick=tick_t, vote_pending=vote_pending)
        decision = no_slots()

    # ---- phase 1b: late phase-1a delivery (a task-phase send) ----------
    late = ~decide & fb.fired(e, live, t, 1)
    if late.any():
        m = host.put(late)
        new, senders = member_map(lambda s: paxos.phase1a_deliver(s, t),
                                  mid)
        mid = _merge(m, new, mid)
        px["px1b_senders"] = torch.where(m, senders, zero)

    # ---- phase 2: alert delivery, aggregation, announce ----------------
    src_alive = ~crashed
    batch_src = mid.pending_deliver.any(dim=-1)
    n_alive = i32((mid.member & src_alive).sum(dim=-1))
    flushers_alive = (ring.ring_pair_factor(batch_src & src_alive)
                      if variant == "ring"
                      else i32((batch_src & src_alive).sum(dim=-1)))
    delivered_down = member_map(cut.deliver_reports, mid, src_alive)
    delivered_up = None
    if t - 2 in host.inject_ticks or t <= host.start + 2:
        # Off its own injection ticks a member's churn batch is empty, so
        # the delivery adds nothing there.
        churn_down, delivered_up = member_map(cut.deliver_churn_reports,
                                              mid, src_alive)
        delivered_down = delivered_down | churn_down
    (reports, seen_down, announce_now, crossed, _explicit,
     implicit_added) = member_map(
        lambda s, d, u, a: cut.aggregate_device(s, d, u, a, settings),
        mid, delivered_down, delivered_up, n_alive > 0)
    announce = read_arrays(announce_now)[0].astype(bool)
    mid = mid._replace(reports=reports, seen_down=seen_down)
    an = announce_now
    if announce.any():
        ph_hi, ph_lo = member_map(votes.proposal_fingerprint, crossed,
                                  mid.uid_hi, mid.uid_lo)
        mid = mid._replace(
            announced=mid.announced | an,
            proposal=where(an, crossed, mid.proposal),
            announce_tick=where(an, tick_t, mid.announce_tick),
            vote_pending=mid.vote_pending | an,
            voters=where(an, mid.member & src_alive, mid.voters),
            phash_hi=where(an, ph_hi, mid.phash_hi),
            phash_lo=where(an, ph_lo, mid.phash_lo))
    vote_senders = torch.where(an, n_alive, zero)
    vote_recipients = torch.where(an, n_member, zero)
    if variant == "ring":
        vote_senders = torch.where(an, 2, zero).to(torch.int32)
    elif variant == "hier" and announce.any():
        if gid is None:
            gid = member_map(lambda hi, lo: hier.group_ids(hi, lo, n_groups),
                             mid.uid_hi, mid.uid_lo)
        vote_senders = torch.where(an, member_map(
            lambda v, m, g: hier.hier_exchange_messages(v, m, g, n_groups),
            mid.member & src_alive, mid.member, gid), zero)
        vote_recipients = torch.where(an, 1, zero).to(torch.int32)

    # ---- phase 3: batch flush (1-tick quiescence) ----------------------
    flusher_mask = mid.pending_flush.any(dim=-1)
    flushers = (ring.ring_pair_factor(flusher_mask) if variant == "ring"
                else i32(flusher_mask.sum(dim=-1)))
    flush_recipients = torch.where(flusher_mask.any(dim=-1), n_member, zero)
    mid = mid._replace(pending_deliver=mid.pending_flush,
                       pending_flush=torch.zeros_like(mid.pending_flush),
                       churn_deliver=mid.churn_flush,
                       churn_flush=torch.zeros_like(mid.churn_flush))

    # ---- phase 4a: churn alert injection -------------------------------
    # Off its own schedule's ticks a member injects nothing, so no mask.
    churn_injected = zero
    if t in host.inject_ticks:
        flush, churn_injected = member_map(
            lambda s, ch: churn_mod.inject(s, ch, t), mid, churn)
        mid = mid._replace(churn_flush=flush)

    # ---- phase 4b: failure-detector interval ---------------------------
    probes_sent = probes_failed = zero
    new = mid
    if t % settings.fd_interval_ticks == 0:
        is_fd = t > mid.fd_gate
        fc, notified, notify_exp, sent, failed = member_map(
            lambda s, fl: monitor.monitor_tick(s, fl, settings, t), mid,
            faults)
        new = mid._replace(fc=where(is_fd, fc, mid.fc),
                           notified=where(is_fd, notified, mid.notified),
                           pending_flush=notify_exp & is_fd[:, None, None])
        probes_sent = torch.where(is_fd, sent, zero)
        probes_failed = torch.where(is_fd, failed, zero)

    # ---- phase 4c: scripted proposes and fallback-timer fires ----------
    for half, due in (("send", fb.sends(e, live, t)),
                      ("fire", ~decide & fb.fires(e, live, t))):
        if due.any():
            m = host.put(due)
            stepped, task_counts = member_map(
                lambda s, r, n: paxos.task_phase(
                    s, r, 0, t, n, half == "send", half == "fire"),
                new, rows, n_member)
            new = _merge(m, stepped, new)
            px.update({k: torch.where(m, v, zero)
                       for k, v in task_counts.items()})
            host.px_gauges = None
    if host.px_gauges is None:
        host.px_gauges = (i32((new.px_timer != I32_MAX).sum(dim=-1)),
                          new.px_crnd_r.amax(dim=-1))
    px_timers_armed, px_coord_round = host.px_gauges
    if variant == "ring" and "pxvote_senders" in px:
        px["pxvote_senders"] = torch.where(px["pxvote_senders"] > 0, 2,
                                           zero).to(torch.int32)

    inv_bits = zero
    if settings.invariant_checks:
        inv_bits = member_map(
            lambda pre, post, d, fd, cd, fm, cm: invariants.check_step(
                pre, post, decide_now=d, fast_decide=fd, classic_decide=cd,
                fast_mask=fm, classic_mask=cm, settings=settings),
            state, new, decide_now, fast, classic, state.proposal,
            pmask & classic[:, None])

    if decide.any() or host.config is None:
        host.config = config_id_limbs(new.idsum_hi, new.idsum_lo,
                                      new.memsum_hi, new.memsum_lo)
    cfg_hi, cfg_lo = host.config
    alerts_in_flight = i32(
        new.pending_flush.any(dim=-1).sum(dim=-1)
        + new.pending_deliver.any(dim=-1).sum(dim=-1)
        + new.churn_flush.sum(dim=-1) + new.churn_deliver.sum(dim=-1))
    log = StepLog(
        tick=tick_t,
        announce_now=announce_now,
        proposal=crossed & an[:, None],
        decide_now=decide_now,
        decision=decision,
        config_hi=cfg_hi, config_lo=cfg_lo,
        n_member=n_member,
        probes_sent=probes_sent, probes_failed=probes_failed,
        flushers=flushers, flush_recipients=flush_recipients,
        flushers_alive=flushers_alive,
        deliver_alive=torch.where(batch_src.any(dim=-1), n_alive, zero),
        vote_senders=vote_senders, vote_recipients=vote_recipients,
        vote_senders_alive=vote_senders_alive,
        vote_deliver_alive=vote_deliver_alive,
        alerts_in_flight=alerts_in_flight,
        cut_reports=i32(new.reports.sum(dim=(-2, -1))),
        implicit_reports=implicit_added,
        vote_tally=vote_tally, quorum=vote_quorum,
        epoch=new.epoch,
        churn_injected=churn_injected,
        partitioned_edges=member_map(
            lambda fl, m: monitor.partitioned_edge_count(fl, m, t), faults,
            new.member),
        link_dropped=zero,
        px_timers_armed=px_timers_armed, px_coord_round=px_coord_round,
        inv_bits=inv_bits,
        **{name: px.get(name, zero) for name in PX_COUNTS},
    )
    host.tick = t
    host.arriving = announce
    return new, log


def fleet_body(state: EngineState, faults: EngineFaults, churn, fallback,
               n_ticks: int, settings: Settings):
    """Run a stacked fleet ``n_ticks`` ticks: one host loop, one set of
    launches a tick for all F members. Every leaf of the inputs carries
    the member axis first; ``churn`` and ``fallback`` are required (inert
    schedules stand in for none, as the reference's fleets have them).
    Returns ``(finals, logs)`` with logs member-major ``[F, T, ...]``,
    and with ``settings.flight_recorder_window > 0`` ``(finals, logs,
    recorders)`` with ``[F, W, G]`` rings."""
    host = _FleetHost(state, churn, fallback)
    logs = []
    for _ in range(int(n_ticks)):
        state, log = _fleet_step(state, faults, settings, host, churn,
                                 fallback)
        logs.append(log)
    logs = StepLog(*[torch.stack(col, dim=1) for col in zip(*logs)])
    if settings.flight_recorder_window:
        return state, logs, recorder.record_fleet_run(logs, settings,
                                                      recorder.record_run)
    return state, logs
