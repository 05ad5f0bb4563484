"""Plain reference of one Rapid cluster in which every process keeps its
own view and receives only what its links let through, tick by tick.

Each process ``r`` has its own view, K-ring monitors over its own
subjects, its own cut detector and its own fast round; a message sent in
tick ``t`` arrives in tick ``t + 1`` unless its sender or receiver has
crashed or an active link window blocks the edge (counted apart as a
link drop when both ends are alive). In tick ``t``, in this order:

1. fast-round votes arrive: a process counts the votes cast in its own
   configuration, one per sender; when one cut holds the fast quorum
   ``N - floor((N-1)/4)`` of its view it decides that cut, which must be
   the one it announced itself: the cut's nodes leave its view, and its
   monitors, detector and round start afresh (probes only after this
   tick);
2. alert batches arrive: a batch from ``s`` carries ``s``'s alerts
   about its subjects on each ring; a process that has not announced
   takes those of its own configuration as reports ``(d, j)`` for the
   members of its view, completes destinations in flux by the rings
   whose observer is itself reported ``L`` times (one pass), and, when
   some destination has ``H`` reports and none lies between ``L`` and
   ``H``, announces the cut and votes for it to every node of its view;
3. every ``fd_interval`` ticks each process probes its distinct
   subjects; a probe fails when either end has crashed or a window
   blocks the edge; after ``fd_failure_threshold`` failures the monitor
   alerts once (on every ring of that subject) and stops probing it;
4. the alerts of the previous tick go out as one batch to every node of
   the sender's view; a process that decided rebuilds its rings.

A process that announced arms a recovery timer at least
``fallback_base_delay_ticks`` ahead; the classic round it would start
is not modelled, so a run in which an announced process has not decided
by then is refused. This file imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import OutOfScope, fold, ids, refuse_unmodelled
from portbench.reference.shared import Universe, fast_quorum, topology

#: The keys of a description this reference models; any other that is
#: not empty is refused rather than answered wrongly.
MODELLED = ("seed", "crashes", "windows")

COLUMNS = (
    "sent", "delivered", "dropped", "probes_sent", "probes_failed",
    "fv_sent", "fv_delivered", "p1a_sent", "p1a_delivered", "p1b_sent",
    "p1b_delivered", "p2a_sent", "p2a_delivered", "p2b_sent",
    "p2b_delivered", "partitioned_edges", "link_dropped", "flags")


def universe(config: dict, device) -> Universe:
    return Universe(config["nodes"], config["K"], device)


def member_summary(out: dict) -> dict:
    """The summary of one member's outputs."""
    return fold.summary(fold.receiver_ticks(out["columns"], out["announce"],
                                            out["decide"]))


class Windows:
    """A member's link windows as dense ``[C]`` masks."""

    def __init__(self, windows, c: int, device):
        self.rows = []
        for w in windows:
            src = torch.zeros(c, dtype=torch.bool, device=device)
            dst = torch.zeros(c, dtype=torch.bool, device=device)
            src[list(w["src"])] = True
            dst[list(w["dst"])] = True
            self.rows.append((src, dst, w))

    @staticmethod
    def active(w, t: int) -> bool:
        if not w["start"] <= t < w["end"]:
            return False
        return w["period"] <= 0 or ((t - w["start"]) // w["period"]) % 2 == 0

    def blocked(self, t: int, c: int, device):
        """bool ``[C, C]``: edge ``src -> dst`` blocked at tick ``t``."""
        out = torch.zeros((c, c), dtype=torch.bool, device=device)
        for src, dst, w in self.rows:
            if self.active(w, t):
                out |= src[:, None] & dst[None, :]
                if w["two_way"]:
                    out |= dst[:, None] & src[None, :]
        return out

    def partitioned(self, t: int, alive) -> int:
        total = 0
        for src, dst, w in self.rows:
            if self.active(w, t):
                a, b = int((src & alive).sum()), int((dst & alive).sum())
                pairs = a * b - int((src & dst & alive).sum())
                total += 2 * pairs if w["two_way"] else pairs
        return total


class Views:
    """Each distinct view's rings, built once."""

    def __init__(self, orders):
        self.orders = orders
        self.cache = {}

    def get(self, row):
        key = row.cpu().numpy().tobytes()
        if key not in self.cache:
            self.cache[key] = topology(row, self.orders)
        return self.cache[key]


def simulate(config: dict, desc: dict, ticks: int, uni: Universe) -> dict:
    """One member's run: per-tick counters, each process's announces and
    decides, and its final view, configuration id and stop flag."""
    refuse_unmodelled(desc, MODELLED, "per-receiver")
    k, hi, lo = config["K"], config["H"], config["L"]
    fd_every = config["fd_interval_ticks"]
    threshold = config["fd_failure_threshold"]
    base_delay = config["fallback_base_delay_ticks"]
    c = config["capacity"]
    if c != uni.n:
        raise OutOfScope("the per-receiver reference models capacity == "
                         "nodes")
    dev = uni.device
    never = 2**62
    crash_np = np.full(c, never, np.int64)
    for slot, tick in desc["crashes"]:
        crash_np[slot] = min(crash_np[slot], tick)
    crash_tick = torch.from_numpy(crash_np).to(dev)
    windows = Windows(desc["windows"], c, dev)
    views = Views(uni.orders)

    member = torch.ones((c, c), dtype=torch.bool, device=dev)
    full = views.get(member[0])
    own_subj = full[0].clone()
    own_active = full[2].clone()
    own_first = full[3].clone()
    obs_full = full[1][None].expand(c, c, k).clone()
    mfp = uni.member_fp
    member_sum = np.full(c, ids.wrap_sum(mfp), np.uint64)
    cfg = np.full(c, ids.config_id(uni.id_sum, int(member_sum[0])),
                  np.uint64)
    px_n = np.full(c, c, np.int64)
    stopped = torch.zeros(c, dtype=torch.bool, device=dev)
    announced = torch.zeros(c, dtype=torch.bool, device=dev)
    seen_down = torch.zeros(c, dtype=torch.bool, device=dev)
    fd_gate = torch.zeros(c, dtype=torch.int64, device=dev)
    fc = torch.zeros((c, k), dtype=torch.int32, device=dev)
    notified = torch.zeros((c, k), dtype=torch.bool, device=dev)
    reports = torch.zeros((c, c, k), dtype=torch.bool, device=dev)
    pf = torch.zeros((c, k), dtype=torch.bool, device=dev)
    pf_dst = own_subj.clone()
    pf_cfg = cfg.copy()
    ann_tick = np.full(c, -1, np.int64)
    # Registered proposals (their masks) and each process's own one.
    proposals, proposal_id = [], {}
    reg = np.full(c, -1, np.int64)
    # Votes seen: the proposal each sender's vote named, or -1.
    seen_vote = torch.full((c, c), -1, dtype=torch.int64, device=dev)
    # The wire: what was sent last tick, arriving this tick.
    batch = vote = None

    cols = {name: np.zeros(ticks, np.int64) for name in COLUMNS}
    ann_mask = np.zeros((ticks, c), bool)
    dec_mask = np.zeros((ticks, c), bool)
    ann_rows, ann_cfgs, dec_rows, dec_cfgs = [], [], [], []

    def deliver(fan, crashed, blocked, row, phase=None):
        ok = fan & ~crashed[:, None] & ~crashed[None, :]
        got = ok & ~blocked
        sent, landed = int(fan.sum()), int(got.sum())
        row["delivered"] += landed
        row["dropped"] += sent - landed
        row["link_dropped"] += int((ok & blocked).sum())
        if phase:
            row[phase] += landed
        return got

    for t in range(1, ticks + 1):
        row = dict.fromkeys(COLUMNS, 0)
        crashed = crash_tick <= t
        blocked = windows.blocked(t, c, dev)
        cfg_dev = torch.from_numpy(cfg.view(np.int64)).to(dev)
        decided = torch.zeros(c, dtype=torch.bool, device=dev)

        # 1. fast-round votes arrive and decide
        if vote is not None:
            got = deliver(vote["fan"], crashed, blocked, row, "fv_delivered")
            gate = got.T & ~stopped[:, None] & (
                vote["cfg"][None, :] == cfg_dev[:, None])
            fresh = gate & (seen_vote < 0)
            if bool(fresh.any()):
                seen_vote = torch.where(fresh, vote["pid"][None, :],
                                        seen_vote)
                quorum = torch.from_numpy(
                    np.array([fast_quorum(int(x)) for x in px_n])).to(dev)
                total = (seen_vote >= 0).sum(dim=1)
                counts = torch.stack([(seen_vote == p).sum(dim=1)
                                      for p in range(len(proposals))], 1)
                wins = (counts >= quorum[:, None]) & (
                    total >= quorum)[:, None]
                if bool((wins.sum(dim=1) > 1).any()):
                    raise OutOfScope("two cuts at the fast quorum")
                decided = wins.any(dim=1) & fresh.any(dim=1)
                winner = torch.argmax(wins.to(torch.uint8), dim=1)
                for r in torch.nonzero(decided).flatten().tolist():
                    p = int(winner[r])
                    if reg[r] != p:
                        raise OutOfScope("a decided cut that its process "
                                         "did not announce")
                    if bool((proposals[p] & ~member[r]).any()):
                        raise OutOfScope("a decided cut outside the view")
                    hosts = proposals[p] & member[r]
                    removed = hosts.cpu().numpy()
                    member_sum[r] = np.uint64(
                        (int(member_sum[r]) - ids.wrap_sum(mfp[removed]))
                        % 2**64)
                    cfg[r] = np.uint64(ids.config_id(uni.id_sum,
                                                     int(member_sum[r])))
                    member[r] &= ~hosts
                    px_n[r] = int(member[r].sum())
                    stopped[r] = stopped[r] | ~member[r, r]
                    dec_mask[t - 1, r] = True
                    dec_rows.append(proposals[p].cpu().numpy())
                    dec_cfgs.append(cfg[r])
                    ann_tick[r] = -1
                if bool(decided.any()):
                    d = decided
                    reports[d] = False
                    seen_down &= ~d
                    announced &= ~d
                    fc[d] = 0
                    notified[d] = False
                    fd_gate = torch.where(d, t, fd_gate)
                    seen_vote[d] = -1
                    cfg_dev = torch.from_numpy(cfg.view(np.int64)).to(dev)

        # 2. alert batches arrive; cuts are announced
        announce = torch.zeros(c, dtype=torch.bool, device=dev)
        if batch is not None:
            got = deliver(batch["fan"], crashed, blocked, row)
            recv = got.T & ~stopped[:, None] & ~announced[:, None] & (
                batch["cfg"][None, :] == cfg_dev[:, None])
            s_idx, j_idx = torch.nonzero(batch["alerts"], as_tuple=True)
            cells = batch["dst"][s_idx, j_idx] * k + j_idx
            down = torch.zeros((c, c * k), dtype=torch.int32, device=dev)
            down.index_add_(1, cells, recv[:, s_idx].to(torch.int32))
            down = (down > 0).view(c, c, k)
            gate = ~announced & ~stopped
            new = down & member[:, :, None] & gate[:, None, None]
            reports |= new
            any_new = new.flatten(1).any(dim=1)
            seen_down |= any_new
            counts = reports.sum(dim=2)
            at_lo = counts >= lo
            flux = at_lo & (counts < hi)
            obs_at_lo = torch.gather(at_lo, 1, obs_full.reshape(c, c * k))
            added = (flux[:, :, None] & obs_at_lo.view(c, c, k) & ~reports
                     & (any_new & seen_down)[:, None, None])
            reports |= added
            counts = reports.sum(dim=2)
            in_flux = ((counts >= lo) & (counts < hi)).any(dim=1)
            crossed = counts >= hi
            announce = (any_new & ~in_flux & crossed.any(dim=1)
                        & ~announced & ~stopped)
            for r in torch.nonzero(announce).flatten().tolist():
                key = crossed[r].cpu().numpy().tobytes()
                if key not in proposal_id:
                    proposal_id[key] = len(proposals)
                    proposals.append(crossed[r].clone())
                reg[r] = proposal_id[key]
                ann_tick[r] = t
                ann_rows.append(crossed[r].cpu().numpy())
                ann_cfgs.append(cfg[r])
            announced |= announce
            ann_mask[t - 1] = announce.cpu().numpy()
        fan = announce[:, None] & member
        row["fv_sent"] = int(fan.sum())
        vote = None if not bool(announce.any()) else {
            "fan": fan, "cfg": cfg_dev.clone(),
            "pid": torch.from_numpy(reg.copy()).to(dev)}
        late = (ann_tick >= 0) & (t >= ann_tick + base_delay)
        if late.any():
            raise OutOfScope(f"tick {t}: a recovery timer would fire (the "
                             f"classic round is not modelled)")

        # 3. the failure detectors probe
        alerts = torch.zeros((c, k), dtype=torch.bool, device=dev)
        if t % fd_every == 0:
            is_fd = (fd_gate < t) & ~stopped
            saturated = fc >= threshold
            probing = own_active & ~saturated & is_fd[:, None]
            fail = crashed[own_subj] | crashed[:, None] | torch.gather(
                blocked, 1, own_subj)
            failed = probing & fail
            row["probes_sent"] = int(probing.sum())
            row["probes_failed"] = int(failed.sum())
            fc = fc + failed.to(torch.int32)
            alerts = own_active & saturated & ~notified & is_fd[:, None]
            notified |= alerts
            alerts = torch.gather(alerts, 1, own_first)

        # 4. last tick's alerts go out; decided processes rebuild
        flush = pf.any(dim=1) & ~stopped
        fan = flush[:, None] & member
        row["sent"] = int(fan.sum()) + row["fv_sent"]
        batch = None if not bool(flush.any()) else {
            "fan": fan, "alerts": pf & flush[:, None], "dst": pf_dst,
            "cfg": torch.from_numpy(pf_cfg.view(np.int64)).to(dev)}
        pf, pf_dst, pf_cfg = alerts, own_subj.clone(), cfg.copy()
        for r in torch.nonzero(decided).flatten().tolist():
            subj, obs, active, first = views.get(member[r])
            own_subj[r], own_active[r], own_first[r] = (
                subj[r], active[r], first[r])
            obs_full[r] = obs

        row["partitioned_edges"] = windows.partitioned(t, ~crashed)
        for name, value in row.items():
            cols[name][t - 1] = value

    def rows(found):
        return np.stack(found) if found else np.zeros((0, c), bool)
    return {
        "columns": cols,
        "announce": ann_mask, "ann_props": rows(ann_rows),
        "ann_prop_bits": int(sum(r.sum() for r in ann_rows)),
        "ann_cfg": np.asarray(ann_cfgs, np.uint64),
        "decide": dec_mask, "dec_hosts": rows(dec_rows),
        "dec_host_bits": int(sum(r.sum() for r in dec_rows)),
        "dec_cfg": np.asarray(dec_cfgs, np.uint64),
        "member": member.cpu().numpy(),
        "config": cfg.copy(),
        "stopped": stopped.cpu().numpy(),
    }
