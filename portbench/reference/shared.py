"""Plain reference of one Rapid cluster whose every alive process sees the
same alert stream (fail-stop crashes only), tick by tick.

One tick is Rapid's 100 ms alert batching window. In tick ``t``:

1. votes cast at the announce tick arrive; when the alive voters reach
   the fast quorum ``N - floor((N-1)/4)`` (every vote names the same
   cut) the cut is decided: its nodes leave the view, the K rings are
   rebuilt over the new view, and the monitors, the cut detector and the
   round start afresh (the failure detector probes again only after
   this tick);
2. alert batches flushed last tick land: an alert from observer ``o``
   about its ring-``j`` subject ``d`` is a report ``(d, j)``, kept if
   ``o`` is alive now. Reports of a destination with at least ``L`` but
   fewer than ``H`` of them are completed by the rings whose observer
   is itself reported at least ``L`` times (one pass). When some
   destination has ``H`` reports and none is between ``L`` and ``H``,
   the cut of every destination at ``H`` or more is announced and every
   alive member votes for it;
3. the batches alerted last tick are flushed to every member;
4. every ``fd_interval`` ticks each member probes each distinct ring
   predecessor (its subjects); a probe fails when either end has
   crashed; after ``fd_failure_threshold`` failures a monitor alerts
   once, on every ring on which it observes that subject, and stops
   probing it.

A contested instance (``proposes``: every member proposes, at one tick,
removing one of a few camps' victims, and arms a fallback timer with its
own delay) runs beside this: the proposes are fast-round votes that
arrive the next tick and reach no fast quorum; the one earliest timer
makes its node the coordinator of a classic round, whose phase 1a, 1b, 2a
and 2b each take a tick, every member promising and accepting; the
coordinator picks the value by the Fast Paxos rule over the first
``N//2 + 1`` promises in ring-0 order (the one value voted there; else
the value whose ``N//4 + 1``-th vote comes first; else the first
value), and the 2b majority decides it ``classic_round_ticks`` (four:
1a, 1b, 2a, 2b) after the fire.

The counters (probes, flushers and recipients, vote senders and
recipients, reports, each classic phase's senders and recipients) and
gauges are those the run's event stream defines. This file imports
nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import OutOfScope, fold, ids, refuse_unmodelled

#: The keys of a description this reference models; any other that is
#: not empty is refused rather than answered wrongly.
MODELLED = ("seed", "crashes", "proposes")


class Universe:
    """What every member of a fleet shares: identities and ring order."""

    def __init__(self, n: int, k: int, device):
        uids, self.id_sum = ids.universe(n)
        self.n = n
        self.member_fp = ids.hash64(uids, ids.SEED_MEMBER)
        self.orders = torch.from_numpy(ids.ring_orders(uids, k)).to(device)
        self.device = device


def universe(config: dict, device) -> Universe:
    return Universe(config["nodes"], config["K"], device)


def member_summary(out: dict) -> dict:
    """The summary of one member's outputs."""
    return fold.summary(fold.shared_ticks(out["columns"]))


def fast_quorum(n: int) -> int:
    return n - (n - 1) // 4


def topology(member, orders):
    """``(subj, obs, fd_active, fd_first)``, each ``[C, K]``: a member's
    ring-``j`` predecessor and successor among the members (itself for a
    non-member), whether ring ``j`` is the first on which it observes
    that subject, and that first ring."""
    k, c = orders.shape
    dev = member.device
    slots = torch.arange(c, device=dev)
    subj = slots[:, None].repeat(1, k)
    obs = subj.clone()
    for j in range(k):
        ring = orders[j]
        on = ring[member[ring]]
        if on.numel():
            subj[on, j] = torch.roll(on, 1)
            obs[on, j] = torch.roll(on, -1)
    ring_ids = torch.arange(k, device=dev)
    same = subj[:, :, None] == subj[:, None, :]                 # [C, i, j]
    earlier = ring_ids[:, None] <= ring_ids[None, :]
    fd_first = torch.argmax((same & earlier).to(torch.uint8), dim=1)
    usable = member & (int(member.sum()) >= 2)
    fd_active = (fd_first == ring_ids[None, :]) & usable[:, None]
    return subj, obs, fd_active, fd_first


class ClassicRound:
    """A member's contested instance, worked out from its description:
    the propose tick, each slot's proposal id (``-1`` for none), the
    coordinator's fire tick and the value the rule picks."""

    def __init__(self, prop: dict, member, orders, n_member: int,
                 round_ticks: int):
        slots = np.arange(len(prop["camp"]))
        victims = np.asarray(prop["victims"])
        values = sorted({(int(v),) for v in victims})
        pid_of_camp = np.array([values.index((int(v),)) for v in victims])
        self.pid = pid_of_camp[np.asarray(prop["camp"])]
        self.masks = [np.isin(slots, v) for v in values]
        self.tick = int(prop["tick"])
        fire = self.tick + np.asarray(prop["delay"], np.int64)
        self.coord = int(np.argmin(fire))
        self.fire = int(fire[self.coord])
        self.decide = self.fire + round_ticks
        others = np.delete(fire, self.coord)
        if (others <= self.decide).any():
            raise OutOfScope("a second timer fires before the classic "
                             "round decides")
        counts = np.bincount(self.pid, minlength=len(values))
        self.best = int(counts.max())
        if self.best >= fast_quorum(n_member):
            raise OutOfScope("a camp reaches the fast quorum")
        # ring-0 positions among the members, the promises' arrival order
        ring0 = orders[0].cpu().numpy()
        on = member.cpu().numpy()[ring0]
        pos = np.empty(len(slots), np.int64)
        pos[ring0] = np.cumsum(on) - 1
        self.chosen = self.rule(pos, n_member)

    def rule(self, pos, n: int) -> int:
        first = pos.min()
        cand = pos < max(n // 2 + 1, first + 1)
        n4 = n // 4
        by_pid = [np.sort(pos[cand & (self.pid == p)])
                  for p in range(len(self.masks))]
        voted = [p for p, got in enumerate(by_pid) if got.size]
        if len(voted) == 1:
            return voted[0]
        crossing = [(got[n4], p) for p, got in enumerate(by_pid)
                    if got.size >= n4 + 1]
        if crossing:
            return min(crossing)[1]
        return int(self.pid[np.argmin(pos)])


def simulate(config: dict, desc: dict, ticks: int, uni: Universe) -> dict:
    """One member's run: the per-tick columns, the announced and decided
    cuts, the final view and configuration id."""
    refuse_unmodelled(desc, MODELLED, "shared")
    k, hi, lo = config["K"], config["H"], config["L"]
    fd_every = config["fd_interval_ticks"]
    threshold = config["fd_failure_threshold"]
    c = config["capacity"]
    n = uni.n
    if c != n:
        raise OutOfScope("the shared reference models capacity == nodes")
    dev = uni.device
    never = 2**62
    crash_np = np.full(c, never, np.int64)
    for slot, tick in desc["crashes"]:
        crash_np[slot] = min(crash_np[slot], tick)
    crash_tick = torch.from_numpy(crash_np).to(dev)
    member = torch.ones(c, dtype=torch.bool, device=dev)
    member_sum = ids.wrap_sum(uni.member_fp)
    config_id = ids.config_id(uni.id_sum, member_sum)
    subj, obs, fd_active, fd_first = topology(member, uni.orders)
    zeros = lambda dtype=torch.bool: torch.zeros((c, k), dtype=dtype,
                                                 device=dev)
    fc, notified = zeros(torch.int32), zeros()
    pending_flush, pending_deliver, reports = zeros(), zeros(), zeros()
    seen_down = announced = vote_pending = False
    proposal = voters = None
    announce_tick, epoch, fd_gate = -1, 0, 0
    n_member = c
    classic = None
    if desc.get("proposes"):
        if desc["crashes"]:
            raise OutOfScope("a contested instance beside crashes")
        classic = ClassicRound(desc["proposes"], member, uni.orders, c,
                               config["classic_round_ticks"])
    armed = coord_round = 0

    cols = {name: np.zeros(ticks, np.int64) for name in COLUMNS}
    announce_ticks, proposals, decide_ticks, decisions = [], [], [], []
    for t in range(1, ticks + 1):
        row = {}
        crashed = crash_tick <= t
        alive = ~crashed
        row["quorum"] = fast_quorum(n_member)
        live = classic is not None and epoch == 0

        # 0. the classic round's messages land; its 2b majority decides
        decide = False
        if live and t > classic.tick:
            row["vote_tally"] = classic.best
            if t == classic.decide:
                decide = True
                proposal = torch.from_numpy(
                    classic.masks[classic.chosen]).to(dev)
            elif t == classic.fire + 2:
                row.update(px2a_senders=1, px2a_recipients=n_member)
            elif t == classic.fire + 3:
                row.update(px2b_senders=n_member, px2b_recipients=n_member)

        # 1. votes arrive, a quorum decides
        if vote_pending and announce_tick + 1 == t:
            valid = voters & alive
            tally = int(valid.sum())
            alive_members = int((member & alive).sum())
            q = fast_quorum(n_member)
            decide = tally >= q and alive_members > 0
            row.update(vote_tally=tally, vote_senders_alive=tally,
                       vote_deliver_alive=alive_members)
            vote_pending = False
        if decide:
            removed = proposal & member
            member = member ^ proposal
            member_sum = (member_sum - ids.wrap_sum(
                uni.member_fp[removed.cpu().numpy()])) % 2**64
            config_id = ids.config_id(uni.id_sum, member_sum)
            subj, obs, fd_active, fd_first = topology(member, uni.orders)
            fc, notified = zeros(torch.int32), zeros()
            pending_flush, pending_deliver, reports = zeros(), zeros(), zeros()
            seen_down = announced = False
            fd_gate = t
            epoch += 1
            armed = coord_round = 0
            n_member = int(member.sum())
            decide_ticks.append(t - 1)
            decisions.append(proposal.cpu().numpy())
            row["decide_now"] = 1

        if live and not decide and t == classic.fire + 1:
            row["px1b_senders"] = n_member

        # 2. alert batches land in the cut detector; an announce
        n_alive = int((member & alive).sum())
        batch_src = pending_deliver.any(dim=1)
        if bool(batch_src.any()):
            row["flushers_alive"] = int((batch_src & alive).sum())
            row["deliver_alive"] = n_alive
        landed = torch.gather(pending_deliver, 0, obs) & alive[obs]
        new = landed & member[:, None] & (n_alive > 0 and not announced)
        any_new = bool(new.any())
        seen_down = seen_down or any_new
        reports = reports | new
        counts = reports.sum(dim=1)
        at_lo = counts >= lo
        flux = at_lo & (counts < hi)
        added = (flux[:, None] & at_lo[obs] & ~reports
                 & (any_new and seen_down))
        reports = reports | added
        row["implicit_reports"] = int(added.sum())
        counts = reports.sum(dim=1)
        crossed = counts >= hi
        in_flux = bool(((counts >= lo) & (counts < hi)).any())
        if any_new and not in_flux and bool(crossed.any()) \
                and not announced:
            announced = vote_pending = True
            proposal, voters, announce_tick = crossed, member & alive, t
            announce_ticks.append(t - 1)
            proposals.append(crossed.cpu().numpy())
            row.update(announce_now=1, vote_senders=n_alive,
                       vote_recipients=n_member)

        # 3. last tick's alerts are flushed
        flushing = pending_flush.any(dim=1)
        if bool(flushing.any()):
            row["flushers"] = int(flushing.sum())
            row["flush_recipients"] = n_member
        pending_deliver, pending_flush = pending_flush, zeros()

        # 4. the failure detectors probe
        if t % fd_every == 0 and t > fd_gate:
            saturated = fc >= threshold
            probing = fd_active & ~saturated
            alert = fd_active & saturated & ~notified
            failed = probing & (crashed[subj] | crashed[:, None])
            fc = fc + failed.to(torch.int32)
            notified = notified | alert
            pending_flush = torch.gather(alert, 1, fd_first)
            row.update(probes_sent=int(probing.sum()),
                       probes_failed=int(failed.sum()))

        # 4c. the proposes go out and arm the timers; the first fires
        if live and t == classic.tick:
            armed = n_member
            row.update(pxvote_senders=n_member, pxvote_recipients=n_member)
        if live and not decide and t == classic.fire:
            armed -= 1
            coord_round = 2
            row.update(px1a_senders=1, px1a_recipients=n_member)

        row.update(
            px_timers_armed=armed, px_coord_round=coord_round,
            n_member=n_member, epoch=epoch,
            config_hi=config_id >> 32, config_lo=config_id & 0xFFFFFFFF,
            alerts_in_flight=int(pending_flush.any(dim=1).sum())
            + int(pending_deliver.any(dim=1).sum()),
            cut_reports=int(reports.sum()))
        for name, value in row.items():
            cols[name][t - 1] = value

    def rows(found):
        return (np.stack(found) if found
                else np.zeros((0, c), bool))
    return {
        "columns": cols,
        "announce_ticks": np.asarray(announce_ticks, np.int64),
        "proposals": rows(proposals),
        "proposal_bits": int(sum(p.sum() for p in proposals)),
        "decide_ticks": np.asarray(decide_ticks, np.int64),
        "decisions": rows(decisions),
        "decision_bits": int(sum(d.sum() for d in decisions)),
        "member": member.cpu().numpy(),
        "config": np.asarray([config_id], np.uint64),
    }


#: The per-tick columns, in the program's log order; the classic-round,
#: churn, link and invariant columns stay 0 in what this models.
COLUMNS = (
    "announce_now", "decide_now", "config_hi", "config_lo", "n_member",
    "probes_sent", "probes_failed", "flushers", "flush_recipients",
    "flushers_alive", "deliver_alive", "vote_senders", "vote_recipients",
    "vote_senders_alive", "vote_deliver_alive", "alerts_in_flight",
    "cut_reports", "implicit_reports", "vote_tally", "quorum", "epoch",
    "churn_injected", "partitioned_edges", "link_dropped",
    "pxvote_senders", "pxvote_recipients", "px1a_senders",
    "px1a_recipients", "px1b_senders", "px2a_senders", "px2a_recipients",
    "px2b_senders", "px2b_recipients", "px_timers_armed", "px_coord_round",
    "inv_bits")
