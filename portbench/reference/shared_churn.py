"""Plain reference of one Rapid cluster under join and graceful leave,
every process alive and seeing the same alert stream, tick by tick.

The universe holds ``capacity`` slots: the ``nodes`` first are the boot
view, the rest dormant joiners whose uids pad the universe
(``hash64(i, seed=0x636170)`` for the ``i``-th pad slot) and whose
identifier fingerprints are ``hash64(slot, seed=0x6964)``. Every slot
has its place on each of the K rings (``ids.ring_orders``); a member's
ring-``j`` observer is the next member after it on ring ``j``, and a
dormant slot's ring-``j`` gatekeeper (the observer it expects once it
joins) the last member before it, both wrapping. The description's
``churn`` entry gives each joiner and leaver the tick its alert batch is
enqueued and the configuration epoch (the count of view changes so far)
that batch expects. In tick ``t``:

1. the votes cast at the announce tick arrive; when the voters reach
   the fast quorum ``N - floor((N-1)/4)`` of the current view (every
   vote names the same cut) the cut is decided: its members leave the
   view and its dormant slots join it; the configuration id counts the
   member fingerprints of the new view and the identifier fingerprints
   of every node that ever joined; the observers and gatekeepers are
   worked out anew over the new view; the cut detector, the alerts in
   flight and the round start afresh, the epoch counts one more view
   change, and the failure detectors probe again only after this tick;
2. the churn batches flushed last tick land: a leaver's DOWN alert on
   ring ``j`` comes from its ring-``j`` observer, a joiner's UP alert
   from its ring-``j`` gatekeeper, each a report ``(slot, j)`` kept while
   no cut is announced. Reports of a destination with at least ``L`` but
   fewer than ``H`` of them are completed by the rings whose reporter is
   itself reported at least ``L`` times (one pass, after any DOWN). When
   some destination has ``H`` reports and none is between ``L`` and
   ``H``, the cut of every destination at ``H`` or more is announced and
   every member votes for it;
3. the alerts of tick ``t`` are enqueued: a joiner's while it is still
   dormant, a leaver's while it is a member, each only if its epoch is
   the view's;
4. the batches whose batching window has closed, those enqueued at tick
   ``t - batching_window_ticks`` or before, are flushed to every member
   (with the shipped window of one tick, last tick's); then, every
   ``fd_interval`` ticks after the last view change, each member probes
   each distinct ring predecessor (its subjects) once. No process
   fails, so no probe fails and no failure detector alerts.

The counters and gauges are those the run's event stream defines: the
batches a tick enqueues, those in flight and the reports held, the votes
sent and counted, the probes. Crashes, link windows and scripted
proposes are not modelled and are refused. This file imports nothing of
the program under test.

``control`` gives the configuration under which this reference is the
control of the comparison (``portbench/own_control.py``): the alert
batching window one tick short, so that every join and leave batch is
flushed in the tick it is enqueued and every view change comes a tick
early.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import OutOfScope, ids, refuse_unmodelled
# member_summary is the shared engine's: the same columns, the same fold.
from portbench.reference.shared import (  # noqa: F401
    COLUMNS, fast_quorum, member_summary, topology)

#: The keys of a description this reference models; any other that is
#: not empty is refused rather than answered wrongly.
MODELLED = ("seed", "churn")
#: The seeds of a pad slot's uid and of a dormant slot's identifier
#: fingerprint.
SEED_PAD = 0x636170
SEED_JOINER = 0x6964


class Universe:
    """What every member of a fleet shares: the padded universe's
    identities, fingerprints and ring order."""

    def __init__(self, n: int, c: int, k: int, device):
        if c < n:
            raise OutOfScope(f"capacity {c} below {n} nodes")
        uids, self.id_sum = ids.universe(n)
        uids = np.concatenate([uids, ids.hash64(
            np.arange(c - n, dtype=np.uint64), SEED_PAD)])
        self.n, self.c = n, c
        self.member_fp = ids.hash64(uids, ids.SEED_MEMBER)
        self.id_fp = np.zeros(c, np.uint64)
        self.id_fp[n:] = ids.hash64(np.arange(n, c, dtype=np.uint64),
                                    SEED_JOINER)
        self.orders = torch.from_numpy(ids.ring_orders(uids, k)).to(device)
        self.device = device


def universe(config: dict, device) -> Universe:
    return Universe(config["nodes"], config["capacity"], config["K"], device)


def control(config: dict) -> dict:
    """The configuration with the alert batching window one tick short."""
    return dict(config,
                batching_window_ticks=config["batching_window_ticks"] - 1)


def gatekeepers(member, orders):
    """``[C, K]``: a dormant slot's ring-``j`` gatekeeper, the last member
    before it on ring ``j`` (wrapping); a member's own slot."""
    k, c = orders.shape
    gk = torch.arange(c, device=member.device)[:, None].repeat(1, k)
    for j in range(k):
        ring = orders[j]
        on = member[ring]
        at = torch.nonzero(on).flatten()
        off = torch.nonzero(~on).flatten()
        if at.numel() and off.numel():
            before = torch.searchsorted(at, off) - 1    # -1 wraps to last
            gk[ring[off], j] = ring[at[before]]
    return gk


def _scheduled(desc: dict, key: str, c: int):
    """``(tick, epoch)`` int64 ``[C]`` of the description's joins or
    leaves; never (``2**62``) for the other slots."""
    tick = np.full(c, 2**62, np.int64)
    epoch = np.zeros(c, np.int64)
    for slot, at, ep in desc["churn"][key]:
        if not 0 <= slot < c:
            raise OutOfScope(f"{key} of slot {slot} outside {c} slots")
        tick[slot], epoch[slot] = at, ep
    return tick, epoch


def simulate(config: dict, desc: dict, ticks: int, uni: Universe) -> dict:
    """One member's run: the per-tick columns, the announced and decided
    cuts, the final view and configuration id."""
    refuse_unmodelled(desc, MODELLED, "shared_churn")
    k, hi, lo = config["K"], config["H"], config["L"]
    fd_every = config["fd_interval_ticks"]
    window = config["batching_window_ticks"]
    if window < 0:
        raise OutOfScope(f"batching window of {window} ticks")
    c, n, dev = uni.c, uni.n, uni.device
    if config["capacity"] != c or config["nodes"] != n:
        raise OutOfScope("the universe is another configuration's")
    on_dev = lambda a: torch.from_numpy(a).to(dev)
    join_tick, join_epoch = map(on_dev, _scheduled(desc, "join", c))
    leave_tick, leave_epoch = map(on_dev, _scheduled(desc, "leave", c))
    member = torch.arange(c, device=dev) < n
    member_np = member.cpu().numpy()
    member_sum = ids.wrap_sum(uni.member_fp[member_np])
    id_sum = uni.id_sum
    config_id = ids.config_id(id_sum, member_sum)

    def views(member):
        _, obs, fd_active, _ = topology(member, uni.orders)
        return obs, gatekeepers(member, uni.orders), fd_active

    obs, gk, fd_active = views(member)
    none = lambda: torch.zeros(c, dtype=torch.bool, device=dev)
    reports = torch.zeros((c, k), dtype=torch.bool, device=dev)
    queued, churn_deliver = none(), none()
    queued_at = torch.zeros(c, dtype=torch.int64, device=dev)
    seen_down = announced = vote_pending = False
    proposal = voters = None
    announce_tick, epoch, fd_gate = -1, 0, 0
    n_member = n

    cols = {name: np.zeros(ticks, np.int64) for name in COLUMNS}
    announce_ticks, proposals, decide_ticks, decisions = [], [], [], []
    for t in range(1, ticks + 1):
        row = {"quorum": fast_quorum(n_member)}

        # 1. votes arrive, a quorum decides
        decide = False
        if vote_pending and announce_tick + 1 == t:
            tally = int(voters.sum())
            decide = tally >= fast_quorum(n_member)
            row.update(vote_tally=tally, vote_senders_alive=tally,
                       vote_deliver_alive=n_member)
            vote_pending = False
        if decide:
            cut = proposal.cpu().numpy()
            joined, removed = cut & ~member_np, cut & member_np
            member_sum = (member_sum - ids.wrap_sum(uni.member_fp[removed])
                          + ids.wrap_sum(uni.member_fp[joined])) % 2**64
            id_sum = (id_sum + ids.wrap_sum(uni.id_fp[joined])) % 2**64
            config_id = ids.config_id(id_sum, member_sum)
            member = member ^ proposal
            member_np = member.cpu().numpy()
            obs, gk, fd_active = views(member)
            reports = torch.zeros_like(reports)
            queued, churn_deliver = none(), none()
            seen_down = announced = False
            fd_gate = t
            epoch += 1
            n_member = int(member_np.sum())
            decide_ticks.append(t - 1)
            decisions.append(cut)
            row["decide_now"] = 1

        # 2. churn batches land in the cut detector (every reporter is
        # alive); an announce
        src = torch.where(member[:, None], obs, gk)
        new = churn_deliver[:, None].expand(c, k) & (not announced)
        any_new = bool(new.any())
        seen_down = seen_down or bool((new & member[:, None]).any())
        reports = reports | new
        counts = reports.sum(dim=1)
        at_lo = counts >= lo
        flux = at_lo & (counts < hi)
        added = (flux[:, None] & at_lo[src] & ~reports
                 & (any_new and seen_down))
        reports = reports | added
        row["implicit_reports"] = int(added.sum())
        counts = reports.sum(dim=1)
        crossed = counts >= hi
        in_flux = bool(((counts >= lo) & (counts < hi)).any())
        if any_new and not in_flux and bool(crossed.any()) \
                and not announced:
            announced = vote_pending = True
            proposal, voters, announce_tick = crossed, member, t
            announce_ticks.append(t - 1)
            proposals.append(crossed.cpu().numpy())
            row.update(announce_now=1, vote_senders=n_member,
                       vote_recipients=n_member)

        # 3. this tick's alerts are enqueued
        now = (((join_tick == t) & ~member & (join_epoch == epoch))
               | ((leave_tick == t) & member & (leave_epoch == epoch)))
        queued = queued | now
        queued_at = torch.where(now, t, queued_at)
        row["churn_injected"] = int(now.sum())
        # 4. the batches whose window closed are flushed; the failure
        # detectors probe
        churn_deliver = queued & (queued_at + window <= t)
        queued = queued & ~churn_deliver
        if t % fd_every == 0 and t > fd_gate:
            row["probes_sent"] = int(fd_active.sum())
        row.update(
            n_member=n_member, epoch=epoch,
            config_hi=config_id >> 32, config_lo=config_id & 0xFFFFFFFF,
            alerts_in_flight=int(queued.sum() + churn_deliver.sum()),
            cut_reports=int(reports.sum()))
        for name, value in row.items():
            cols[name][t - 1] = value

    def rows(found):
        return np.stack(found) if found else np.zeros((0, c), bool)
    return {
        "columns": cols,
        "announce_ticks": np.asarray(announce_ticks, np.int64),
        "proposals": rows(proposals),
        "proposal_bits": int(sum(p.sum() for p in proposals)),
        "decide_ticks": np.asarray(decide_ticks, np.int64),
        "decisions": rows(decisions),
        "decision_bits": int(sum(d.sum() for d in decisions)),
        "member": member_np,
        "config": np.asarray([config_id], np.uint64),
    }
