"""The host adversary engine: exact replay of unscripted fault schedules.

Own copy of the reference's ``engine.adversary``, plain Python and numpy
on the host (no device). It executes a seeded
``faults.AdversarySchedule`` with per-slot protocol state (each slot's
membership view and configuration epoch, cut-detector report tables,
alert pipeline and Fast Paxos instance, with organic jittered fallback
timers) and reproduces the oracle bit for bit with no scenario
screening at all.

Exactness comes from replaying the oracle's two global orderings:
``SimNetwork`` delivers every message due in a tick in global
send-sequence order, so each send is stamped with a global sequence
number; ``SimScheduler`` runs due jobs in registration-handle order, so
handles are allocated at the same points (per-node FD jobs, then the
alert batcher at boot; scripted proposes after boot; fallback timers at
propose time) and popped alike. Identities, ring keys and config ids
use ``hashing``; link windows evaluate through ``LinkWindow``; the
per-tick gauges match ``engine.monitor.partitioned_edge_count``.

``engine.diff.run_adversarial_differential`` holds this engine against
the oracle, and ``run_receiver_differential`` holds the per-receiver
device engine against this one.
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from rapid_tpu_torch import hashing
from rapid_tpu_torch.engine.paxos import adversary_rngs
from rapid_tpu_torch.faults import AdversarySchedule, ScriptedPropose, \
    delay_of_slots, validate_schedule
from rapid_tpu_torch.settings import DEFAULT_SETTINGS, Settings
from rapid_tpu_torch.telemetry.trace import span

MASK64 = hashing.MASK64

#: Shared identity-seed constants (the oracle's membership_view and the
#: engines' topology hash with the same ones).
_SEED_MEMBER = 0x6D656D62
_SEED_RANK = 0x72616E6B

#: Wire message kind -> consensus phase counter name (batches and probes
#: carry no phase).
_PHASE_OF = {
    "vote": "fast_vote",
    "1a": "phase1a",
    "1b": "phase1b",
    "2a": "phase2a",
    "2b": "phase2b",
}

#: Message counter keys, matching the oracle's ``NetworkCounters``.
COUNTER_KEYS = ("sent", "delivered", "dropped", "timeouts",
                "probes_sent", "probes_failed")

#: Per-phase counter keys, matching ``SimNetwork.consensus_history``.
PHASE_KEYS = tuple(f"{p}_{d}" for p in
                   ("fast_vote", "phase1a", "phase1b", "phase2a", "phase2b")
                   for d in ("sent", "delivered"))


class AdversaryExecutionError(RuntimeError):
    """A schedule drove the protocol somewhere the oracle itself would
    crash (e.g. a decided proposal removing an already-removed node)."""


class _PaxosInstance:
    """One Fast Paxos instance: slot-indexed mirror of the per-config
    consensus state (``oracle.paxos``). Ranks are ``(round, node_index)``
    tuples — the same lexicographic order as the oracle's ``Rank``."""

    __slots__ = ("node", "cfg", "n", "rnd", "vrnd", "vval", "crnd", "cval",
                 "p1b", "p2b", "px_decided", "fp_decided",
                 "votes_received", "votes_per_proposal", "timer_handle")

    def __init__(self, node: int, cfg: int, n: int) -> None:
        self.node = node
        self.cfg = cfg
        self.n = n
        self.rnd = (0, 0)
        self.vrnd = (0, 0)
        self.vval: Tuple[int, ...] = ()
        self.crnd = (0, 0)
        self.cval: Tuple[int, ...] = ()
        self.p1b: Dict[int, Tuple[Tuple[int, int], Tuple[int, ...]]] = {}
        self.p2b: Dict[Tuple[int, int], Dict[int, Tuple[int, ...]]] = {}
        self.px_decided = False
        self.fp_decided = False
        self.votes_received: Set[int] = set()
        self.votes_per_proposal: Dict[Tuple[int, ...], int] = {}
        self.timer_handle: Optional[int] = None


class _Node:
    """Per-slot membership service state: own view + config epoch, own
    cut-detector tables, own alert pipeline, own consensus instance."""

    __slots__ = ("member_key", "memsum", "cfg", "stopped", "announced",
                 "queue", "last_enq", "bcast", "reports", "pre", "prop",
                 "updates", "seen_down", "fds", "fd_jobs", "batcher_job",
                 "px")

    def __init__(self, member_key: FrozenSet[int], memsum: int,
                 cfg: int) -> None:
        self.member_key = member_key
        self.memsum = memsum
        self.cfg = cfg
        self.stopped = False
        self.announced = False
        self.queue: List[Tuple[int, int, int, Tuple[int, ...]]] = []
        self.last_enq = -1
        self.bcast: List[int] = []
        self.reports: Dict[int, Dict[int, int]] = {}
        self.pre: Dict[int, None] = {}
        self.prop: Dict[int, None] = {}
        self.updates = 0
        self.seen_down = False
        self.fds: List[dict] = []
        self.fd_jobs: List[dict] = []
        self.batcher_job: Optional[dict] = None
        self.px: Optional[_PaxosInstance] = None


@dataclass
class AdversaryRun:
    """Everything the adversarial differential compares.

    ``events_by_slot[r]`` holds ``(tick, kind, config_id, slots)`` tuples
    (kind in {"proposal", "view_change"}, slots ascending); counters and
    phase histories carry per-tick deltas starting at tick 1.
    """

    n: int
    n_ticks: int
    events_by_slot: List[List[Tuple[int, str, int, Tuple[int, ...]]]]
    tick_history: List[Dict[str, int]]
    phase_history: List[Dict[str, int]]
    partitioned_edges: List[int]
    link_dropped: List[int]
    config_ids: List[int]
    members_by_slot: List[FrozenSet[int]]
    stopped: List[bool]
    totals: Dict[str, int] = field(default_factory=dict)
    phase_totals: Dict[str, int] = field(default_factory=dict)

    def metrics(self) -> List:
        """Normalize into ``telemetry.metrics.TickMetrics`` rows (engine
        source) so forensics reports can name the fault context —
        partitioned-edge and link-drop gauges — of a divergent tick."""
        from rapid_tpu_torch.telemetry.metrics import TickMetrics

        with span("rapid.fold"):
            ann = {e[0] for evs in self.events_by_slot for e in evs
                   if e[1] == "proposal"}
            dec = {e[0] for evs in self.events_by_slot for e in evs
                   if e[1] == "view_change"}
            out = []
            for i, c in enumerate(self.tick_history):
                tick = i + 1
                px = self.phase_history[i]
                out.append(TickMetrics(
                    tick=tick, source="engine", **c,
                    partitioned_edges=self.partitioned_edges[i],
                    link_dropped=self.link_dropped[i],
                    px_fast_vote_sent=px["fast_vote_sent"],
                    px_phase1a_sent=px["phase1a_sent"],
                    px_phase1b_sent=px["phase1b_sent"],
                    px_phase2a_sent=px["phase2a_sent"],
                    px_phase2b_sent=px["phase2b_sent"],
                    announce=tick in ann, decide=tick in dec))
            return out


class AdversaryEngine:
    """Slot-indexed executor of one :class:`AdversarySchedule`.

    ``uids`` are the 64-bit node identities in slot order and
    ``id_fp_sum`` the (removal-invariant) identifier fingerprint sum —
    both supplied by the harness so this module never imports the
    oracle. All protocol state lives in slot coordinates.
    """

    def __init__(self, schedule: AdversarySchedule, uids: Sequence[int],
                 id_fp_sum: int, settings: Optional[Settings] = None) -> None:
        validate_schedule(schedule)
        if len(uids) != schedule.n:
            raise ValueError("uids must cover the schedule universe")
        self.schedule = schedule
        self.settings = settings or DEFAULT_SETTINGS
        self.n = schedule.n
        self.k = self.settings.K
        self.uids = [int(u) & MASK64 for u in uids]
        self.id_fp_sum = int(id_fp_sum) & MASK64
        self.memfp = [hashing.hash64(u, seed=_SEED_MEMBER)
                      for u in self.uids]
        self.rank_idx = [hashing.hash64(u, seed=_SEED_RANK) & 0x7FFFFFFF
                         for u in self.uids]
        self.ringkey = [[hashing.hash64(u, seed=k) for k in range(self.k)]
                        for u in self.uids]
        self.rngs = adversary_rngs(schedule.seed, self.n)
        self.crash_ticks = schedule.crash_tick_array()

        # replicated scheduler + wire
        self.now = 0
        self._heap: List[Tuple[int, int, tuple]] = []
        self._hseq = itertools.count()
        self._cancelled: Set[int] = set()
        self._wire: Dict[int, List[tuple]] = {}
        self._wseq = itertools.count()

        self.counters = dict.fromkeys(COUNTER_KEYS, 0)
        self.phase_counters = dict.fromkeys(PHASE_KEYS, 0)
        self.tick_history: List[Dict[str, int]] = []
        self.phase_history: List[Dict[str, int]] = []
        self.part_edges_history: List[int] = []
        self.link_dropped_history: List[int] = []
        self.events: List[List[tuple]] = [[] for _ in range(self.n)]

        self._topo_cache: Dict[FrozenSet[int], dict] = {}
        self._E: Optional[np.ndarray] = None
        self._crashed_now: Optional[np.ndarray] = None
        self._link_dropped_tick = 0

        self.nodes: List[_Node] = []
        self._boot()

    # -- identity / topology -------------------------------------------------

    def _r0key(self, slot: int) -> Tuple[int, int]:
        """View-independent global ring-0 sort key (proposal ordering)."""
        return (self.ringkey[slot][0], self.uids[slot])

    def _config_id(self, memsum: int) -> int:
        return hashing.splitmix64(
            (hashing.splitmix64(self.id_fp_sum) + memsum) & MASK64)

    def _rings(self, member_key: FrozenSet[int]) -> dict:
        """Per-view ring topology: K-ring subject/observer tables plus the
        ring-0 broadcast order. Same sort key as the engines' topology
        (``engine.topology``): (hash64(uid, seed=ring), uid)."""
        topo = self._topo_cache.get(member_key)
        if topo is not None:
            return topo
        members = sorted(member_key)
        subj: Dict[int, List[int]] = {}
        obs: Dict[int, List[int]] = {}
        if len(members) >= 2:
            for k in range(self.k):
                order = sorted(members,
                               key=lambda s: (self.ringkey[s][k],
                                              self.uids[s]))
                pos = {s: i for i, s in enumerate(order)}
                for s in members:
                    i = pos[s]
                    subj.setdefault(s, [0] * self.k)[k] = \
                        order[(i - 1) % len(order)]
                    obs.setdefault(s, [0] * self.k)[k] = \
                        order[(i + 1) % len(order)]
        ring0 = sorted(members,
                       key=lambda s: (self.ringkey[s][0], self.uids[s]))
        topo = {"subj": subj, "obs": obs, "ring0": ring0}
        self._topo_cache[member_key] = topo
        return topo

    # -- replicated scheduler ------------------------------------------------

    def _schedule(self, delay: int, task: tuple) -> int:
        handle = next(self._hseq)
        heapq.heappush(self._heap, (self.now + max(0, delay), handle, task))
        return handle

    def _schedule_periodic(self, interval: int, task: tuple) -> dict:
        job = {"cancelled": False, "interval": interval, "task": task}
        self._schedule(interval - (self.now % interval), ("periodic", job))
        return job

    def _run_due(self) -> None:
        while self._heap and self._heap[0][0] <= self.now:
            _, handle, task = heapq.heappop(self._heap)
            if handle in self._cancelled:
                self._cancelled.discard(handle)
                continue
            self._dispatch(task)

    def _dispatch(self, task: tuple) -> None:
        kind = task[0]
        if kind == "periodic":
            job = task[1]
            inner = job["task"]
            r = inner[1]
            if job["cancelled"] or self.nodes[r].stopped:
                return
            if inner[0] == "fd":
                self._fd_tick(r, inner[2])
            else:
                self._batcher_tick(r)
            self._schedule(job["interval"], ("periodic", job))
        elif kind == "timer":
            px = task[1]
            if not px.fp_decided:
                self._start_phase1a(px, 2)
        elif kind == "scripted":
            p: ScriptedPropose = task[1]
            ordered = tuple(sorted(p.proposal, key=self._r0key))
            self._propose(p.slot, self.nodes[p.slot], ordered,
                          p.delay_ticks)

    # -- boot ----------------------------------------------------------------

    def _boot(self) -> None:
        universe = frozenset(range(self.n))
        memsum = sum(self.memfp) & MASK64
        cfg = self._config_id(memsum)
        topo = self._rings(universe)
        # Per node in slot order: broadcaster + consensus instance (no
        # scheduling), then FD jobs, then the alert batcher — the exact
        # handle order the oracle's service constructor produces.
        for r in range(self.n):
            nd = _Node(universe, memsum, cfg)
            nd.bcast = list(topo["ring0"])
            nd.px = _PaxosInstance(r, cfg, self.n)
            self.nodes.append(nd)
            self._create_fds(r, nd)
            nd.batcher_job = self._schedule_periodic(1, ("batcher", r))
        # Scripted proposes register after boot, in schedule order.
        for p in self.schedule.proposes:
            self._schedule(p.tick - self.now, ("scripted", p))

    def _create_fds(self, r: int, nd: _Node) -> None:
        topo = self._rings(nd.member_key)
        subjects = topo["subj"].get(r, [])
        for subject in dict.fromkeys(subjects):
            fd = {"subject": subject, "fc": 0, "notified": False,
                  "cfg": nd.cfg}
            nd.fds.append(fd)
            nd.fd_jobs.append(self._schedule_periodic(
                self.settings.fd_interval_ticks, ("fd", r, fd)))

    # -- fault evaluation ----------------------------------------------------

    def _edge_matrix(self, tick: int) -> Optional[np.ndarray]:
        """bool [n, n]: directed edges blocked by active link windows at
        the delivery tick (None when the schedule has no windows)."""
        if not self.schedule.windows:
            return None
        blocked = np.zeros((self.n, self.n), dtype=bool)
        for w in self.schedule.windows:
            if not w.active(tick):
                continue
            s = np.zeros(self.n, dtype=bool)
            d = np.zeros(self.n, dtype=bool)
            s[list(w.src_slots)] = True
            d[list(w.dst_slots)] = True
            blocked |= s[:, None] & d[None, :]
            if w.two_way:
                blocked |= d[:, None] & s[None, :]
        return blocked

    def _partitioned_edges(self, tick: int, crashed: np.ndarray) -> int:
        """Gauge matching ``engine.monitor.partitioned_edge_count``:
        per-window alive directed pairs, self-edges excluded, overlapping
        windows counted once each."""
        total = 0
        for w in self.schedule.windows:
            if not w.active(tick):
                continue
            src_m = sum(1 for s in w.src_slots if not crashed[s])
            dst_m = sum(1 for s in w.dst_slots if not crashed[s])
            both = sum(1 for s in (w.src_slots & w.dst_slots)
                       if not crashed[s])
            pairs = src_m * dst_m - both
            total += pairs * 2 if w.two_way else pairs
        return total

    # -- wire ----------------------------------------------------------------

    def _send(self, src: int, dst: int, kind: str, payload: tuple) -> None:
        self.counters["sent"] += 1
        phase = _PHASE_OF.get(kind)
        if phase:
            self.phase_counters[phase + "_sent"] += 1
        # Delay rules are evaluated at send time (latency is a property of
        # the wire the message entered); crashes and link windows still
        # apply at the delivery tick. Within a tick the global wseq sort
        # keeps send order, so jittered delays reorder across ticks
        # exactly like the oracle's per-tick in-flight buckets.
        delay = delay_of_slots(self.schedule.delays, self.schedule.seed,
                               src, dst, self.now)
        self._wire.setdefault(self.now + 1 + delay, []).append(
            (next(self._wseq), src, dst, kind, payload))

    def _broadcast(self, src: int, kind: str, payload: tuple) -> None:
        for dst in self.nodes[src].bcast:
            self._send(src, dst, kind, payload)

    # -- failure detection + alert pipeline ----------------------------------

    def _fd_tick(self, r: int, fd: dict) -> None:
        nd = self.nodes[r]
        if fd["fc"] >= self.settings.fd_failure_threshold:
            if not fd["notified"]:
                fd["notified"] = True
                self._edge_failure_notification(r, nd, fd)
            return
        self.counters["probes_sent"] += 1
        subject = fd["subject"]
        fail = (bool(self._crashed_now[subject])
                or bool(self._crashed_now[r])
                or (self._E is not None and self._E[r, subject]))
        if fail:
            self.counters["probes_failed"] += 1
            fd["fc"] += 1

    def _edge_failure_notification(self, r: int, nd: _Node,
                                   fd: dict) -> None:
        if fd["cfg"] != nd.cfg:
            return
        subjects = self._rings(nd.member_key)["subj"].get(r, [])
        rings = tuple(k for k, s in enumerate(subjects)
                      if s == fd["subject"])
        nd.last_enq = self.now
        nd.queue.append((fd["cfg"], r, fd["subject"], rings))

    def _batcher_tick(self, r: int) -> None:
        nd = self.nodes[r]
        if not nd.queue or nd.last_enq < 0:
            return
        if self.now - nd.last_enq < self.settings.batching_window_ticks:
            return
        alerts = tuple(nd.queue)
        nd.queue.clear()
        self._broadcast(r, "batch", alerts)

    # -- cut detection -------------------------------------------------------

    def _handle_batch(self, r: int, nd: _Node, alerts: tuple) -> None:
        if nd.announced:
            return
        cfg = nd.cfg
        proposal: Dict[int, None] = {}
        for acfg, asrc, adst, rings in alerts:
            if acfg != cfg:
                continue
            if adst not in nd.member_key:
                continue
            for ring in rings:
                for node in self._aggregate(nd, asrc, adst, ring):
                    proposal[node] = None
        for node in self._invalidate(nd):
            proposal[node] = None
        if proposal:
            nd.announced = True
            self._record(r, "proposal", cfg, tuple(sorted(proposal)))
            ordered = tuple(sorted(proposal, key=self._r0key))
            self._propose(r, nd, ordered, None)

    def _aggregate(self, nd: _Node, src: int, dst: int,
                   ring: int) -> List[int]:
        nd.seen_down = True
        reports = nd.reports.setdefault(dst, {})
        if ring in reports:
            return []
        reports[ring] = src
        num = len(reports)
        if num == self.settings.L:
            nd.updates += 1
            nd.pre[dst] = None
        if num == self.settings.H:
            nd.pre.pop(dst, None)
            nd.prop[dst] = None
            nd.updates -= 1
            if nd.updates == 0:
                flushed = list(nd.prop)
                nd.prop.clear()
                return flushed
        return []

    def _invalidate(self, nd: _Node) -> List[int]:
        if not nd.seen_down:
            return []
        obs_table = self._rings(nd.member_key)["obs"]
        out: List[int] = []
        for node in list(nd.pre):
            for ring, ob in enumerate(obs_table.get(node, [])):
                if ob in nd.prop or ob in nd.pre:
                    out.extend(self._aggregate(nd, ob, node, ring))
        return out

    # -- consensus -----------------------------------------------------------

    def _propose(self, r: int, nd: _Node, ordered: Tuple[int, ...],
                 recovery_delay: Optional[int]) -> None:
        px = nd.px
        if not px.rnd[0] > 1:
            px.rnd = (1, 1)
            px.vrnd = (1, 1)
            px.vval = tuple(ordered)
        self._broadcast(r, "vote", (px.cfg, tuple(ordered)))
        if recovery_delay is None:
            u = self.rngs[r].random()
            jitter_ms = -1000.0 * math.log(1.0 - u) * px.n
            recovery_delay = self.settings.fallback_base_delay_ticks + \
                max(0, round(jitter_ms / self.settings.tick_ms))
        px.timer_handle = self._schedule(recovery_delay, ("timer", px))

    def _start_phase1a(self, px: _PaxosInstance, round_: int) -> None:
        if px.crnd[0] > round_:
            return
        px.crnd = (round_, self.rank_idx[px.node])
        self._broadcast(px.node, "1a", (px.cfg, px.crnd))

    def _handle_vote(self, px: _PaxosInstance, src: int,
                     payload: tuple) -> None:
        cfg, prop = payload
        if cfg != px.cfg:
            return
        if src in px.votes_received:
            return
        if px.fp_decided:
            return
        px.votes_received.add(src)
        count = px.votes_per_proposal.get(prop, 0) + 1
        px.votes_per_proposal[prop] = count
        f = (px.n - 1) // 4
        if len(px.votes_received) >= px.n - f and count >= px.n - f:
            self._decide(px, prop)

    def _handle_1a(self, px: _PaxosInstance, src: int,
                   payload: tuple) -> None:
        cfg, rank = payload
        if cfg != px.cfg:
            return
        if px.rnd < rank:
            px.rnd = rank
        else:
            return
        self._send(px.node, src, "1b", (px.cfg, px.rnd, px.vrnd, px.vval))

    def _handle_1b(self, px: _PaxosInstance, src: int,
                   payload: tuple) -> None:
        cfg, rnd, vrnd, vval = payload
        if cfg != px.cfg:
            return
        if px.crnd != rnd:
            return
        px.p1b[src] = (vrnd, tuple(vval))
        if len(px.p1b) > px.n // 2:
            chosen = self._select_proposal(list(px.p1b.values()), px.n)
            if not px.cval and chosen:
                px.cval = chosen
                self._broadcast(px.node, "2a", (px.cfg, px.crnd, chosen))

    @staticmethod
    def _select_proposal(msgs: List[Tuple[Tuple[int, int],
                                          Tuple[int, ...]]],
                         n: int) -> Tuple[int, ...]:
        """The coordinator's CP-safe value-choice rule, replicated."""
        max_vrnd = max(vrnd for vrnd, _ in msgs)
        collected = [vval for vrnd, vval in msgs
                     if vrnd == max_vrnd and len(vval) > 0]
        chosen: Optional[Tuple[int, ...]] = None
        if len(set(collected)) == 1:
            chosen = collected[0]
        elif len(collected) > 1:
            counters: Dict[Tuple[int, ...], int] = {}
            for value in collected:
                count = counters.setdefault(value, 0)
                if count + 1 > n // 4:
                    chosen = value
                    break
                counters[value] = count + 1
        if chosen is None:
            chosen = next((vval for _, vval in msgs if len(vval) > 0), ())
        return chosen

    def _handle_2a(self, px: _PaxosInstance, src: int,
                   payload: tuple) -> None:
        cfg, rnd, vval = payload
        if cfg != px.cfg:
            return
        if px.rnd <= rnd and px.vrnd != rnd:
            px.rnd = rnd
            px.vrnd = rnd
            px.vval = tuple(vval)
            self._broadcast(px.node, "2b", (px.cfg, rnd, px.vval))

    def _handle_2b(self, px: _PaxosInstance, src: int,
                   payload: tuple) -> None:
        cfg, rnd, vval = payload
        if cfg != px.cfg:
            return
        in_rnd = px.p2b.setdefault(rnd, {})
        in_rnd[src] = vval
        if len(in_rnd) > px.n // 2 and not px.px_decided:
            px.px_decided = True
            self._decide(px, tuple(vval))

    def _decide(self, px: _PaxosInstance, hosts: Tuple[int, ...]) -> None:
        if px.fp_decided:
            return
        px.fp_decided = True
        if px.timer_handle is not None:
            self._cancelled.add(px.timer_handle)
            px.timer_handle = None
        self._decide_view_change(px.node, hosts)

    def _decide_view_change(self, r: int, hosts: Tuple[int, ...]) -> None:
        nd = self.nodes[r]
        for job in nd.fd_jobs:
            job["cancelled"] = True
        nd.fd_jobs = []
        nd.fds = []
        members = set(nd.member_key)
        for s in hosts:
            if s not in members:
                raise AdversaryExecutionError(
                    f"decided proposal removes slot {s} which is not in "
                    f"node {r}'s view (the oracle would crash here too)")
            members.discard(s)
            nd.memsum = (nd.memsum - self.memfp[s]) & MASK64
        nd.member_key = frozenset(members)
        nd.cfg = self._config_id(nd.memsum)
        self._record(r, "view_change", nd.cfg, tuple(sorted(hosts)))
        nd.reports = {}
        nd.pre = {}
        nd.prop = {}
        nd.updates = 0
        nd.seen_down = False
        nd.announced = False
        nd.px = _PaxosInstance(r, nd.cfg, len(nd.member_key))
        nd.bcast = list(self._rings(nd.member_key)["ring0"])
        if r in nd.member_key:
            self._create_fds(r, nd)
        else:
            nd.stopped = True
            if nd.batcher_job is not None:
                nd.batcher_job["cancelled"] = True

    def _record(self, r: int, kind: str, cfg: int,
                slots: Tuple[int, ...]) -> None:
        self.events[r].append((self.now, kind, cfg, slots))

    # -- tick loop -----------------------------------------------------------

    def _handle(self, dst: int, src: int, kind: str, payload: tuple) -> None:
        nd = self.nodes[dst]
        if nd.stopped:
            return
        if kind == "batch":
            self._handle_batch(dst, nd, payload)
        elif kind == "vote":
            self._handle_vote(nd.px, src, payload)
        elif kind == "1a":
            self._handle_1a(nd.px, src, payload)
        elif kind == "1b":
            self._handle_1b(nd.px, src, payload)
        elif kind == "2a":
            self._handle_2a(nd.px, src, payload)
        elif kind == "2b":
            self._handle_2b(nd.px, src, payload)

    def step(self) -> None:
        t = self.now + 1
        self.now = t
        before = dict(self.counters)
        before_phase = dict(self.phase_counters)
        self._E = self._edge_matrix(t)
        self._crashed_now = self.crash_ticks <= t
        self._link_dropped_tick = 0
        for _, src, dst, kind, payload in sorted(self._wire.pop(t, [])):
            if self._crashed_now[src]:
                self.counters["dropped"] += 1
                continue
            blocked = self._E is not None and self._E[src, dst]
            if self._crashed_now[dst] or blocked:
                self.counters["dropped"] += 1
                if not self._crashed_now[dst]:
                    self._link_dropped_tick += 1
                continue
            self.counters["delivered"] += 1
            phase = _PHASE_OF.get(kind)
            if phase:
                self.phase_counters[phase + "_delivered"] += 1
            self._handle(dst, src, kind, payload)
        self._run_due()
        self.tick_history.append(
            {k: self.counters[k] - before[k] for k in COUNTER_KEYS})
        self.phase_history.append(
            {k: self.phase_counters[k] - before_phase[k]
             for k in PHASE_KEYS})
        self.part_edges_history.append(
            self._partitioned_edges(t, self._crashed_now))
        self.link_dropped_history.append(self._link_dropped_tick)

    def run(self, n_ticks: int) -> AdversaryRun:
        for _ in range(n_ticks):
            self.step()
        return AdversaryRun(
            n=self.n,
            n_ticks=n_ticks,
            events_by_slot=[list(evs) for evs in self.events],
            tick_history=list(self.tick_history),
            phase_history=list(self.phase_history),
            partitioned_edges=list(self.part_edges_history),
            link_dropped=list(self.link_dropped_history),
            config_ids=[nd.cfg for nd in self.nodes],
            members_by_slot=[nd.member_key for nd in self.nodes],
            stopped=[nd.stopped for nd in self.nodes],
            totals=dict(self.counters),
            phase_totals=dict(self.phase_counters),
        )
