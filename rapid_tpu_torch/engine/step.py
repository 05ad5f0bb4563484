"""The shared-state tick engine: one view stands in for every receiver.

Exact for crash faults: every alive receiver sees the same alert stream,
so one cut detector and one fast round serve them all. Link windows and
probe drop perturb the failure detector's probes only. Phase order
inside a tick mirrors the reference's ``rapid_tpu.engine.step``:

1. **decide**: fast-round votes sent at the announce tick arrive; a
   quorum triggers the view change (membership XOR with the proposal,
   64-bit member and identifier sums, the sort-free topology rebuild,
   and the reset of monitor, cut and consensus state);
2. **deliver**: alert batches flushed last tick land in the cut
   detector; an H-crossing with no destination in flux announces the
   proposal and casts the votes;
3. **flush**: batches enqueued at the last FD tick move to delivery;
4. **monitor** (4b): on ticks ``t % fd_interval_ticks == 0`` past
   ``fd_gate``, every node probes its subjects.

Where the reference lowers one ``lax.scan`` with two ``lax.cond`` and a
``lax.while_loop``, the port runs eagerly: the tick is a host int, and
the data-dependent branches read 0-d tensors on the host
(``device.read_host``). ``cut.aggregate`` reads once whether the tick
announces. Votes arrive exactly one tick after an announce, so
``simulate`` carries that read into the next tick and reads the arrival
bit from the state only on its first tick; a tick with arriving votes
reads once more whether they decide. What a branch skips is provably
what the reference computes and then masks away:

- the vote count, on ticks when no votes arrive (its outputs are masked
  to 0);
- the view change, on ticks that do not decide (``lax.cond``);
- the proposal fingerprint and the announce updates, on ticks that do
  not announce (``jnp.where`` on a false flag);
- ``monitor_tick`` when ``t % fd_interval_ticks != 0`` (``is_fd`` is
  false, so its results are masked away); its other half,
  ``t > fd_gate``, is on the device and stays a ``torch.where``.

This slice runs ``protocol_variant="rapid"`` without churn, fallback,
invariant checks, flight recorder or mesh; each of those raises
``NotImplementedError`` naming its ``ROADMAP.md`` queue item.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from rapid_tpu_torch import hashing
from rapid_tpu_torch.device import read_host, resolve_device
from rapid_tpu_torch.engine import cut, monitor, votes
from rapid_tpu_torch.engine.state import (
    EngineFaults, EngineState, StepLog, config_id_limbs)
from rapid_tpu_torch.engine.topology import build_topology
from rapid_tpu_torch.settings import Settings


def require_scope(settings: Settings, churn=None, fallback=None,
                  mesh=None) -> None:
    """Refuse what the shared engine's slice does not port yet."""
    later = (
        (settings.protocol_variant != "rapid",
         f"protocol_variant={settings.protocol_variant!r}: the ring and "
         f"hier variants are ROADMAP.md Queue 1 item 4"),
        (churn is not None,
         "churn schedules are ROADMAP.md Queue 1 item 2"),
        (fallback is not None,
         "the classic-Paxos fallback is ROADMAP.md Queue 1 item 3"),
        (settings.invariant_checks,
         "invariant_checks=True: the invariant monitor is ROADMAP.md "
         "Queue 1 item 5"),
        (settings.flight_recorder_window != 0,
         "flight_recorder_window > 0: the flight recorder is ROADMAP.md "
         "Queue 1 item 5"),
        (mesh is not None,
         "a device mesh: sharding is ROADMAP.md Queue 1 item 10"),
    )
    for refused, why in later:
        if refused:
            raise NotImplementedError(
                f"{why}; the shared engine's port does not run it yet")


def _view_change(state: EngineState, pmask):
    """The decided view: member XOR ``pmask``, the 64-bit sums, and the
    topology rebuilt from the static ring order."""
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
    return dict(member=member, memsum_hi=ms_hi, memsum_lo=ms_lo,
                idsum_hi=id_hi, idsum_lo=id_lo, subj_idx=subj, obs_idx=obs,
                gk_idx=gk, fd_active=fd_active, fd_first=fd_first)


def step(state: EngineState, faults: EngineFaults, settings: Settings,
         churn=None, fallback=None, mesh=None, *, tick: Optional[int] = None):
    """Advance the shared engine by one tick; returns ``(state, log)``.

    ``tick`` is ``state.tick`` as a host int, read from the state when
    omitted. ``churn``, ``fallback`` and ``mesh`` exist to be refused.
    """
    require_scope(settings, churn, fallback, mesh)
    if tick is None:
        (tick,) = read_host(state.tick)
    new, log, _ = _step(state, faults, settings, int(tick) + 1, None, None)
    return new, log


def _step(state: EngineState, faults: EngineFaults, settings: Settings,
          t: int, config, arriving: Optional[bool]):
    """One tick ``t`` (``state.tick + 1``); returns ``(state, log,
    announced)`` with ``announced`` a host bool.

    ``config`` is the ``(hi, lo)`` config-id limbs of ``state``'s sums, or
    None to compute them: the sums change only in a view change, and the
    two splitmix64 rounds of the id on 0-d limbs are about 200 kernel
    launches. ``arriving`` says whether fast-round votes arrive this tick
    (the last tick announced), or None to read it from the state.
    """
    dev = state.member.device
    c = state.member.shape[0]
    i32 = lambda x: x.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    no_slots = lambda: torch.zeros(c, dtype=torch.bool, device=dev)
    crashed = monitor.crashed_at(faults, t)
    tick_t = state.tick + 1

    # ---- phase 1: vote delivery and decision --------------------------
    votes_arriving = state.vote_pending & (state.announce_tick + 1 == t)
    if arriving is None:
        (arriving,) = read_host(votes_arriving)
    decide = False
    decide_now = torch.zeros((), dtype=torch.bool, device=dev)
    vote_tally = vote_quorum = vote_senders_alive = vote_deliver_alive = zero
    vote_pending = state.vote_pending
    if arriving:
        n_member = i32(state.member.sum())
        alive_members = state.member & ~crashed
        valid = state.voters & ~crashed
        decided, vote_tally = votes.count_fast_round(
            state.phash_hi.expand(c), state.phash_lo.expand(c), valid,
            n_member)
        vote_quorum = votes.fast_quorum(n_member)
        # A decision needs an alive receiver to count the votes.
        decide_now = decided & alive_members.any()
        vote_senders_alive = i32(valid.sum())
        vote_deliver_alive = i32(alive_members.sum())
        vote_pending = vote_pending & ~votes_arriving
        (decide,) = read_host(decide_now)

    if decide:
        ck_false = torch.zeros_like(state.reports)
        mid = state._replace(
            tick=tick_t, **_view_change(state, state.proposal),
            fc=torch.zeros_like(state.fc), notified=ck_false,
            fd_gate=tick_t, pending_flush=ck_false,
            pending_deliver=ck_false,
            churn_flush=no_slots(), churn_deliver=no_slots(),
            reports=ck_false, seen_down=torch.zeros_like(decide_now),
            announced=torch.zeros_like(decide_now), proposal=no_slots(),
            vote_pending=vote_pending, voters=no_slots(),
            epoch=state.epoch + 1)
        decision = state.proposal
    else:
        mid = state._replace(tick=tick_t, vote_pending=vote_pending)
        decision = no_slots()

    # ---- phase 2: alert delivery, aggregation, announce ----------------
    src_alive = ~crashed
    batch_src = mid.pending_deliver.any(dim=1)
    flushers_alive = i32((batch_src & src_alive).sum())
    n_alive = i32((mid.member & src_alive).sum())
    (reports, seen_down, announce_now, crossed, _explicit,
     implicit_added, announce) = cut.aggregate(
        mid, cut.deliver_reports(mid, src_alive), None, n_alive > 0,
        settings)
    mid = mid._replace(reports=reports, seen_down=seen_down)
    if announce:
        ph_hi, ph_lo = votes.proposal_fingerprint(crossed, mid.uid_hi,
                                                  mid.uid_lo)
        mid = mid._replace(
            announced=mid.announced | announce_now, proposal=crossed,
            announce_tick=tick_t,
            vote_pending=mid.vote_pending | announce_now,
            voters=mid.member & src_alive, phash_hi=ph_hi, phash_lo=ph_lo)
    n_member_now = i32(mid.member.sum())
    vote_senders = n_alive if announce else zero
    vote_recipients = n_member_now if announce else zero

    # ---- phase 3: batch flush (1-tick quiescence) ----------------------
    flusher_mask = mid.pending_flush.any(dim=1)
    flushers = i32(flusher_mask.sum())
    flush_recipients = torch.where(flusher_mask.any(), n_member_now, zero)
    mid = mid._replace(pending_deliver=mid.pending_flush,
                       pending_flush=torch.zeros_like(mid.pending_flush),
                       churn_deliver=mid.churn_flush,
                       churn_flush=torch.zeros_like(mid.churn_flush))

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

    if decide or config is None:
        config = config_id_limbs(new.idsum_hi, new.idsum_lo,
                                 new.memsum_hi, new.memsum_lo)
    cfg_hi, cfg_lo = config
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
        churn_injected=zero,
        partitioned_edges=monitor.partitioned_edge_count(faults, new.member,
                                                         t),
        link_dropped=zero,
        pxvote_senders=zero, pxvote_recipients=zero,
        px1a_senders=zero, px1a_recipients=zero, px1b_senders=zero,
        px2a_senders=zero, px2a_recipients=zero,
        px2b_senders=zero, px2b_recipients=zero,
        px_timers_armed=zero, px_coord_round=zero,
        inv_bits=zero,
    )
    return new, log, announce


def stack_logs(logs: List[StepLog]) -> StepLog:
    """Per-tick logs -> one log with a leading tick axis."""
    return StepLog(*[torch.stack(f) for f in zip(*logs)])


def simulate(state: EngineState, faults: EngineFaults, n_ticks: int,
             settings: Settings, churn=None, fallback=None, mesh=None,
             device="cuda"):
    """Run ``n_ticks`` shared-engine steps on ``device``, where ``state``
    and ``faults`` must live; returns ``(final, logs)`` with every
    ``StepLog`` field stacked on a leading tick axis, as the reference's
    ``lax.scan`` gives them."""
    require_scope(settings, churn, fallback, mesh)
    dev = resolve_device(device)
    for name, where in (("state", state.member.device),
                        ("faults", faults.crash_tick.device)):
        if where.type != dev.type:
            raise ValueError(f"{name} lives on {where}, the run was asked "
                             f"for {dev}")
    (t0,) = read_host(state.tick)
    logs = []
    config = arriving = None
    for i in range(int(n_ticks)):
        state, log, arriving = _step(state, faults, settings, t0 + i + 1,
                                     config, arriving)
        config = (log.config_hi, log.config_lo)
        logs.append(log)
    return state, stack_logs(logs)
