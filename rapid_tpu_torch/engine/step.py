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
mesh raises ``NotImplementedError`` (``ROADMAP.md`` Queue 1 item 10).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from rapid_tpu_torch import hashing
from rapid_tpu_torch.device import read_arrays, read_host, resolve_device
from rapid_tpu_torch.engine import churn as churn_mod
from rapid_tpu_torch.engine import (cut, invariants, monitor, paxos,
                                    recorder, votes)
from rapid_tpu_torch.engine.state import (
    I32_MAX, EngineFaults, EngineState, StepLog, config_id_limbs)
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
            "a device mesh: sharding is ROADMAP.md Queue 1 item 10; the "
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
        rec = recorder.record_run(recorder.init(settings, device=dev), logs,
                                  settings)
        return state, logs, rec
    return state, logs
