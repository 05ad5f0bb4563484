"""The differential harness: one scenario through the host oracle and an
engine, compared bit for bit.

Own copy of the reference's ``engine.diff``. The oracle
(``rapid_tpu_torch.oracle``) is the semantic referee: N Python objects
exchanging messages one event at a time on the host. Each runner drives
the same scenario through it and through one of the port's engines on
``device`` (default ``"cuda"``; ``device="cpu"`` runs the engines' plain
PyTorch versions), and its result compares:

- every proposal announcement and view-change decision: tick, slots and
  64-bit configuration id;
- the per-tick message counters (the shared engine logs sender and
  recipient factors; ``expand_counters`` multiplies them out in Python
  ints into the oracle's ``SimNetwork`` counters) and, where consensus
  is contested, the per-phase consensus counters;
- the final configuration ids and memberships.

``run_differential``, ``run_churn_differential``,
``run_fallback_differential``, ``run_variant_differential`` and
``run_lineage_differential`` drive the shared engine
(``step.simulate``; churn planned by ``churn.plan_churn``, contested
instances by ``paxos.plan_fallback``, which raise their envelope errors
before either side runs). ``run_adversarial_differential`` holds the
host adversary engine (``engine.adversary``) against the oracle, host
against host, per slot; ``run_receiver_differential`` holds the
per-receiver device engine (``receiver.receiver_simulate``) against the
host adversary engine. Every ``assert_identical`` raises
``telemetry.forensics.DivergenceError`` at the first divergence and can
write its JSONL artifact.

``boot_static_cluster`` wires every oracle ``MembershipService`` from one
converged ``MembershipView`` instead of running N joins (O(N**3)
messages), so a differential at N=256 runs in seconds. ``mesh=`` (of
``run_differential`` and ``run_variant_differential``) places the
engine's state and faults on a slot mesh (``sharding.shard_put``) and
runs there: on one device as it is, on ``D`` devices split into ``C /
D`` slots per shard, a thread each (``step.simulate``); the results
equal the run without a mesh bit for bit.

The host-side extractors of the shared engine's stacked ``StepLog`` live
here too: the event stream and the exact per-tick counts, from tensors
on any device or numpy arrays.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rapid_tpu_torch.device import resolve_device
from rapid_tpu_torch.events import ClusterEvents
from rapid_tpu_torch.faults import HEALTHY, CrashFault, FaultModel
from rapid_tpu_torch.oracle.cluster import Cluster
from rapid_tpu_torch.oracle.membership_view import MembershipView, uid_of
from rapid_tpu_torch.oracle.simulation import SimNetwork
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import Endpoint, NodeId


@dataclass(frozen=True)
class ViewEvent:
    """One protocol-visible event, in canonical (slot-index) coordinates."""

    tick: int
    kind: str               # "proposal" | "view_change"
    config_id: int          # at fire time: pre-change for proposals,
                            # post-change for view changes
    slots: Tuple[int, ...]  # proposed / removed slots, ascending

    def as_dict(self) -> Dict[str, object]:
        return {"tick": self.tick, "kind": self.kind,
                "config_id": self.config_id, "slots": list(self.slots)}

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "ViewEvent":
        return ViewEvent(tick=int(d["tick"]), kind=str(d["kind"]),
                         config_id=int(d["config_id"]),
                         slots=tuple(int(s) for s in d["slots"]))


def write_events_jsonl(events: Sequence[ViewEvent], path) -> None:
    """One ViewEvent per line, so oracle and engine streams written to two
    files diff cleanly with standard line tools."""
    with open(path, "w") as fh:
        for e in events:
            fh.write(json.dumps(e.as_dict(), sort_keys=True) + "\n")


def read_events_jsonl(path) -> List[ViewEvent]:
    out: List[ViewEvent] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(ViewEvent.from_dict(json.loads(line)))
    return out


def default_endpoints(n: int) -> List[Endpoint]:
    """Deterministic distinct endpoints for an n-node scenario."""
    return [Endpoint(f"n{i}.sim", 5000) for i in range(n)]


def default_node_ids(n: int) -> List[NodeId]:
    return [NodeId(i + 1, (i + 1) * 7919) for i in range(n)]


class _Recorder:
    """Collects ViewEvents fired by one oracle node."""

    def __init__(self, network: SimNetwork,
                 slot_of: Dict[Endpoint, int]) -> None:
        self._network = network
        self._slot_of = slot_of
        self.events: List[ViewEvent] = []

    def subscribe(self, cluster: Cluster) -> None:
        cluster.register_subscription(
            ClusterEvents.VIEW_CHANGE_PROPOSAL, self._on("proposal"))
        cluster.register_subscription(
            ClusterEvents.VIEW_CHANGE, self._on("view_change"))

    def _on(self, kind: str):
        def callback(change):
            # Endpoints joining after the static boot get slots on demand
            # (shared dict, deterministic fire order => stable numbering).
            slots = tuple(sorted(
                self._slot_of.setdefault(nc.endpoint, len(self._slot_of))
                for nc in change.status_changes))
            self.events.append(ViewEvent(
                self._network.tick, kind, change.configuration_id, slots))
        return callback

    def write_jsonl(self, path) -> None:
        """Dump this node's recorded stream for offline diffing."""
        write_events_jsonl(self.events, path)


def boot_static_cluster(
    settings: Settings,
    endpoints: Sequence[Endpoint],
    node_ids: Sequence[NodeId],
    fault_model: FaultModel = HEALTHY,
    rngs: Optional[Sequence] = None,
) -> Tuple[SimNetwork, List[Cluster], List[_Recorder]]:
    """Wire one converged oracle node per endpoint, in slot order.

    Slot order = service creation order, which fixes the scheduler-handle
    order of the periodic jobs — the property that makes the oracle's
    intra-tick alert order canonical and engine-reproducible. ``rngs``
    injects one ``random.Random`` per slot for the fallback-jitter draws
    (the cluster's default rng hashes the listen address object, which is
    ``PYTHONHASHSEED``-dependent — differentials that exercise organic
    timers must pin the streams).
    """
    network = SimNetwork(settings, fault_model)
    slot_of = {e: i for i, e in enumerate(endpoints)}
    clusters: List[Cluster] = []
    recorders: List[_Recorder] = []
    for i, ep in enumerate(endpoints):
        cluster = Cluster(network, ep, settings,
                          rng=rngs[i] if rngs is not None else None)
        recorder = _Recorder(network, slot_of)
        recorder.subscribe(cluster)
        view = MembershipView(settings.K, list(node_ids), list(endpoints))
        cluster._wire_service(view, {})
        clusters.append(cluster)
        recorders.append(recorder)
    # The initial VIEW_CHANGE each service fires at creation is boot noise,
    # not a protocol event: drop it from every recorder.
    for recorder in recorders:
        recorder.events = [e for e in recorder.events if e.tick > 0
                           or e.kind != "view_change"]
    return network, clusters, recorders


def run_oracle(network: SimNetwork, n_ticks: int) -> List[Dict[str, int]]:
    """Step the oracle ``n_ticks`` times; returns per-tick counter dicts.

    The same records accumulate on ``network.tick_history`` (the full
    run), which ``telemetry.oracle_metrics`` consumes."""
    start = len(network.tick_history)
    for _ in range(n_ticks):
        network.step()
    return [dict(d) for d in network.tick_history[start:]]


def oracle_events(
    recorders: Sequence[_Recorder],
    alive_slots: Sequence[int],
) -> List[ViewEvent]:
    """The canonical oracle event stream.

    Every never-crashed node must have seen the identical stream (they
    process identical alert/vote traffic under crash faults); asserts that
    and returns one copy.
    """
    assert alive_slots, "need at least one alive node to define the stream"
    reference = recorders[alive_slots[0]].events
    for slot in alive_slots[1:]:
        assert recorders[slot].events == reference, (
            f"oracle node {slot} diverged from node {alive_slots[0]}: "
            f"{recorders[slot].events} != {reference}")
    return list(reference)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def engine_events(logs) -> List[ViewEvent]:
    """The engine's event stream from stacked StepLogs."""
    ticks = _np(logs.tick)
    ann = _np(logs.announce_now)
    dec = _np(logs.decide_now)
    proposal = _np(logs.proposal)
    decision = _np(logs.decision)
    cfg = ((_np(logs.config_hi).astype(np.uint64) << np.uint64(32))
           | _np(logs.config_lo).astype(np.uint64))
    events: List[ViewEvent] = []
    for i in range(len(ticks)):
        if ann[i]:
            events.append(ViewEvent(
                int(ticks[i]), "proposal", int(cfg[i]),
                tuple(int(s) for s in np.nonzero(proposal[i])[0])))
        if dec[i]:
            events.append(ViewEvent(
                int(ticks[i]), "view_change", int(cfg[i]),
                tuple(int(s) for s in np.nonzero(decision[i])[0])))
    return events


def expand_counters(logs) -> List[Dict[str, int]]:
    """Per-tick exact message counts from the StepLog factors.

    ``dropped`` at tick t is what came due at t and was not delivered:
    last tick's sends minus this tick's deliveries, per traffic class.
    """
    col = lambda name: [int(v) for v in _np(getattr(logs, name))]
    flushers, flush_rcpt = col("flushers"), col("flush_recipients")
    flush_alive, deliver_alive = col("flushers_alive"), col("deliver_alive")
    vote_send, vote_rcpt = col("vote_senders"), col("vote_recipients")
    vote_alive, vote_deliver = (col("vote_senders_alive"),
                                col("vote_deliver_alive"))
    probes_sent, probes_failed = col("probes_sent"), col("probes_failed")
    px = expand_fallback_counters(logs)

    out: List[Dict[str, int]] = []
    prev_batch_sent = prev_vote_sent = 0
    for i in range(len(flushers)):
        batch_sent = flushers[i] * flush_rcpt[i]
        vote_sent = vote_send[i] * vote_rcpt[i]
        batch_delivered = flush_alive[i] * deliver_alive[i]
        vote_delivered = vote_alive[i] * vote_deliver[i]
        px_sent = sum(v for k, v in px[i].items() if k.endswith("_sent"))
        px_delivered = sum(v for k, v in px[i].items()
                           if k.endswith("_delivered"))
        out.append({
            "sent": batch_sent + vote_sent + px_sent,
            "delivered": batch_delivered + vote_delivered + px_delivered,
            "dropped": (prev_batch_sent - batch_delivered)
                       + (prev_vote_sent - vote_delivered),
            "timeouts": 0,
            "probes_sent": probes_sent[i],
            "probes_failed": probes_failed[i],
        })
        prev_batch_sent = batch_sent
        prev_vote_sent = vote_sent
    return out


#: (log field pair -> phase key) for the classic-Paxos message classes.
_PX_CLASSES = (
    ("pxvote_senders", "pxvote_recipients", "fast_vote"),
    ("px1a_senders", "px1a_recipients", "phase1a"),
    ("px1b_senders", None, "phase1b"),              # unicast: 1 recipient
    ("px2a_senders", "px2a_recipients", "phase2a"),
    ("px2b_senders", "px2b_recipients", "phase2b"),
)


def expand_fallback_counters(logs) -> List[Dict[str, int]]:
    """Per-tick per-phase consensus message counts from the StepLog
    factors; every message sent at t-1 is delivered at t."""
    fields = {name: [int(v) for v in _np(getattr(logs, name))]
              for s, r, _ in _PX_CLASSES
              for name in (s, r) if name is not None}
    out: List[Dict[str, int]] = []
    prev = {phase: 0 for _, _, phase in _PX_CLASSES}
    for i in range(len(_np(logs.tick))):
        row: Dict[str, int] = {}
        for s_name, r_name, phase in _PX_CLASSES:
            sent = fields[s_name][i]
            if r_name is not None:
                sent *= fields[r_name][i]
            row[f"{phase}_sent"] = sent
            row[f"{phase}_delivered"] = prev[phase]
            prev[phase] = sent
        out.append(row)
    return out


def _raise_divergence(report, artifact: Optional[str]) -> None:
    from rapid_tpu_torch.telemetry.forensics import DivergenceError

    path = artifact or os.environ.get("RAPID_TPU_FORENSICS")
    if path:
        report.write_jsonl(path)
    raise DivergenceError(report, path)


def _crash_runs(n: int, crash_ticks: Dict[int, int], n_ticks: int,
                settings: Settings, dev, mesh=None):
    """A crash scenario through the oracle and the shared engine on
    ``dev`` (on ``mesh``, a slot mesh, when given): the
    oracle's counters, per-phase counters, events and final config id
    (from the first never-crashed node), the engine's final state and
    host logs, and each side's seconds."""
    endpoints = default_endpoints(n)
    node_ids = default_node_ids(n)

    # --- oracle side ----------------------------------------------------
    t0 = time.perf_counter()
    fault_model = CrashFault({endpoints[s]: t for s, t in crash_ticks.items()})
    network, clusters, recorders = boot_static_cluster(
        settings, endpoints, node_ids, fault_model)
    oracle_counts = run_oracle(network, n_ticks)
    alive = [s for s in range(n) if s not in crash_ticks]
    events_oracle = oracle_events(recorders, alive)
    view = clusters[alive[0]].membership_service.view
    t1 = time.perf_counter()

    # --- engine side ----------------------------------------------------
    uids = [uid_of(e) for e in endpoints]
    final, logs = _run_shared(
        settings, dev, uids, view._id_fp_sum,
        [crash_ticks.get(s) for s in range(n)], n_ticks, mesh=mesh)
    return SimpleNamespace(
        oracle_counts=oracle_counts,
        oracle_phase=[dict(d) for d in network.consensus_history],
        events_oracle=events_oracle,
        oracle_cfg=view.get_current_configuration_id(), uids=uids,
        final=final, logs=logs,
        seconds={"oracle": t1 - t0, "engine": time.perf_counter() - t1})


def _run_shared(settings: Settings, dev, uids, id_fp_sum: int,
                crash_ticks: Sequence, n_ticks: int, *, member=None,
                id_fps=None, churn=None, fallback=None, mesh=None):
    """Boot and run the shared engine on ``dev``; returns the final state
    and the logs, read to the host in one transfer. ``churn`` and
    ``fallback`` are host schedules (or a ``ChurnPlan``); ``mesh`` a
    slot mesh the state and faults are placed on (split over it when it
    has several devices)."""
    from rapid_tpu_torch.convert import from_reference
    from rapid_tpu_torch.engine import sharding
    from rapid_tpu_torch.engine.state import crash_faults, init_state
    from rapid_tpu_torch.engine.step import simulate
    from rapid_tpu_torch.telemetry.metrics import host_log

    state = init_state(uids, id_fp_sum, settings, member=member,
                       id_fps=id_fps, device=dev)
    faults = crash_faults(crash_ticks, device=dev)
    if mesh is not None:
        capacity = int(state.member.shape[0])
        state = sharding.shard_put(state, mesh, capacity)
        faults = sharding.shard_put(faults, mesh, capacity)
    if churn is not None:
        churn = from_reference(churn, dev)
    if fallback is not None:
        fallback = from_reference(fallback, dev)
    final, logs = simulate(state, faults, n_ticks, settings, churn=churn,
                           fallback=fallback, mesh=mesh, device=dev)
    return final, host_log(logs, logs._fields)


@dataclass
class DiffResult:
    n: int
    n_ticks: int
    oracle_events: List[ViewEvent]
    engine_events: List[ViewEvent]
    oracle_counters: List[Dict[str, int]]
    engine_counters: List[Dict[str, int]]
    oracle_config_id: int
    engine_config_id: int
    # unified TickMetrics streams (telemetry), populated by run_differential
    engine_metrics: Optional[List] = None
    oracle_metrics: Optional[List] = None
    # host wall seconds of each side ("oracle", "plan", "referee" for the
    # host adversary engine, "engine" for the run and its host reads)
    seconds: Optional[Dict[str, float]] = None

    def first_divergence(self):
        """The earliest (tick, field) where engine and oracle disagree,
        as a ``DivergenceReport`` with trailing context — None if
        bit-identical."""
        from rapid_tpu_torch.telemetry import forensics as fz

        div = fz.earliest([
            fz.events_divergence(self.engine_events, self.oracle_events),
            fz.counters_divergence(self.engine_counters,
                                   self.oracle_counters),
            fz.scalar_divergence("config_id", self.engine_config_id,
                                 self.oracle_config_id, tick=self.n_ticks),
        ])
        if div is None:
            return None
        return fz.build_report(div, engine_metrics=self.engine_metrics,
                               oracle_metrics=self.oracle_metrics,
                               events=self.oracle_events)

    def assert_identical(self, artifact: Optional[str] = None) -> None:
        """Raise ``DivergenceError`` (an AssertionError) at the first
        divergence, naming tick and field with context records; writes a
        JSONL forensics artifact to ``artifact`` (or the path in the
        ``RAPID_TPU_FORENSICS`` env var) when given."""
        report = self.first_divergence()
        if report is not None:
            _raise_divergence(report, artifact)


def run_differential(
    n: int,
    crash_ticks: Dict[int, int],
    n_ticks: int,
    settings: Optional[Settings] = None,
    mesh=None,
    device="cuda",
) -> DiffResult:
    """Replay a crash scenario through oracle and the shared engine on
    ``device`` and collect both.

    ``crash_ticks`` maps slot index -> crash tick. Call
    ``result.assert_identical()`` for the bit-identical checks. ``mesh``
    is a slot mesh of any size the engine runs on.
    """
    from rapid_tpu_torch.engine.state import state_config_id
    from rapid_tpu_torch.engine.step import require_scope

    require_scope(mesh)
    run = _crash_runs(n, crash_ticks, n_ticks, settings or Settings(),
                      resolve_device(device), mesh)
    logs, oracle_counts = run.logs, run.oracle_counts

    from rapid_tpu_torch.telemetry import metrics as telemetry_metrics

    return DiffResult(
        n=n, n_ticks=n_ticks,
        oracle_events=run.events_oracle,
        engine_events=engine_events(logs),
        oracle_counters=oracle_counts,
        engine_counters=expand_counters(logs),
        oracle_config_id=run.oracle_cfg,
        engine_config_id=state_config_id(run.final),
        engine_metrics=telemetry_metrics.engine_metrics(logs),
        oracle_metrics=telemetry_metrics.oracle_metrics(
            oracle_counts, run.events_oracle),
        seconds=run.seconds,
    )


# ---------------------------------------------------------------------------
# churn differential: joins + graceful leaves (+ crashes) vs the oracle
# ---------------------------------------------------------------------------


@dataclass
class ChurnDiffResult:
    """Oracle vs engine vs planner for a dynamic-membership scenario.

    Message counters are *not* compared here: the join/leave RPC traffic
    (PreJoin, JoinMessage, LeaveMessage, streamed join responses) is
    host-side protocol the engine deliberately does not send. The
    bit-identical contract covers the protocol-visible stream — proposal
    announcements, view-change decisions, their ticks, member slots and
    64-bit configuration ids — plus the final membership.
    """

    n_initial: int
    capacity: int
    n_ticks: int
    oracle_events: List[ViewEvent]
    engine_events: List[ViewEvent]
    plan_events: List[ViewEvent]
    oracle_config_id: int
    engine_config_id: int
    plan_config_id: int
    oracle_members: frozenset
    engine_members: frozenset
    plan_members: frozenset
    # engine TickMetrics stream (telemetry); oracle counters are not
    # compared for churn, so no oracle stream here
    engine_metrics: Optional[List] = field(default=None)
    # host wall seconds of each side ("oracle", "plan", "referee" for the
    # host adversary engine, "engine" for the run and its host reads)
    seconds: Optional[Dict[str, float]] = None

    def first_divergence(self):
        """Earliest disagreement across the engine/plan/oracle triangle
        (``plan_*`` fields hold the planner's value in the engine slot),
        as a ``DivergenceReport`` — None when all three agree."""
        from rapid_tpu_torch.telemetry import forensics as fz

        div = fz.earliest([
            fz.events_divergence(self.engine_events, self.oracle_events),
            fz.events_divergence(self.plan_events, self.oracle_events,
                                 prefix="plan_events"),
            fz.scalar_divergence("config_id", self.engine_config_id,
                                 self.oracle_config_id, tick=self.n_ticks),
            fz.scalar_divergence("plan_config_id", self.plan_config_id,
                                 self.oracle_config_id, tick=self.n_ticks),
            fz.scalar_divergence("members", self.engine_members,
                                 self.oracle_members, tick=self.n_ticks),
            fz.scalar_divergence("plan_members", self.plan_members,
                                 self.oracle_members, tick=self.n_ticks),
        ])
        if div is None:
            return None
        return fz.build_report(div, engine_metrics=self.engine_metrics,
                               events=self.oracle_events)

    def assert_identical(self, artifact: Optional[str] = None) -> None:
        """Raise ``DivergenceError`` at the first triangle divergence;
        see ``DiffResult.assert_identical`` for the artifact contract."""
        report = self.first_divergence()
        if report is not None:
            _raise_divergence(report, artifact)


@dataclass
class FallbackDiffResult:
    """Oracle vs engine for a scripted contested-consensus scenario.

    On top of the ``DiffResult`` contract (events, total per-tick message
    counts, final configuration id), compares the per-*phase* consensus
    message counts — fast-round votes and classic phase 1a/1b/2a/2b — at
    every tick: the engine's ``expand_fallback_counters`` against the
    oracle's ``SimNetwork.consensus_history``.
    """

    n: int
    n_ticks: int
    plan_info: Dict[str, object]
    oracle_events: List[ViewEvent]
    engine_events: List[ViewEvent]
    oracle_counters: List[Dict[str, int]]
    engine_counters: List[Dict[str, int]]
    oracle_phase_counters: List[Dict[str, int]]
    engine_phase_counters: List[Dict[str, int]]
    oracle_config_id: int
    engine_config_id: int
    engine_metrics: Optional[List] = None
    oracle_metrics: Optional[List] = None
    # host wall seconds of each side ("oracle", "plan", "referee" for the
    # host adversary engine, "engine" for the run and its host reads)
    seconds: Optional[Dict[str, float]] = None

    def first_divergence(self):
        """Earliest (tick, field) disagreement across events, total
        counters, per-phase counters and the final config id — None when
        bit-identical."""
        from rapid_tpu_torch.telemetry import forensics as fz

        div = fz.earliest([
            fz.events_divergence(self.engine_events, self.oracle_events),
            fz.counters_divergence(self.engine_counters,
                                   self.oracle_counters),
            fz.counters_divergence(self.engine_phase_counters,
                                   self.oracle_phase_counters),
            fz.scalar_divergence("config_id", self.engine_config_id,
                                 self.oracle_config_id, tick=self.n_ticks),
        ])
        if div is None:
            return None
        return fz.build_report(div, engine_metrics=self.engine_metrics,
                               oracle_metrics=self.oracle_metrics,
                               events=self.oracle_events)

    def assert_identical(self, artifact: Optional[str] = None) -> None:
        """Raise ``DivergenceError`` at the first divergence; see
        ``DiffResult.assert_identical`` for the artifact contract."""
        report = self.first_divergence()
        if report is not None:
            _raise_divergence(report, artifact)


def run_fallback_differential(
    n: int,
    values: Sequence[Sequence[int]],
    votes: Dict[int, Tuple[int, int]],
    delays: Dict[int, int],
    n_ticks: int,
    settings: Optional[Settings] = None,
    device="cuda",
) -> FallbackDiffResult:
    """Replay one contested consensus instance through oracle and engine.

    ``values[p]`` lists the member slots proposal ``p`` removes;
    ``votes[s] = (tick, pid)`` scripts slot ``s``'s ``propose`` call at
    that tick with that value; ``delays[s]`` is its explicit fallback
    delay in ticks (``recovery_delay_ticks`` on the oracle side, the
    schedule's ``prop_delay`` on the engine side — one shared
    deterministic draw instead of two RNG streams). The planner raises
    ``FallbackEnvelopeError`` for scenarios outside the bit-identical
    envelope before either simulation runs.
    """
    from rapid_tpu_torch.engine.state import state_config_id

    dev = resolve_device(device)
    run = _contested_runs(n, values, votes, delays, n_ticks,
                          settings or Settings(), dev)
    logs, oracle_counts = run.logs, run.oracle_counts
    events_oracle = run.events_oracle

    from rapid_tpu_torch.telemetry import metrics as telemetry_metrics

    return FallbackDiffResult(
        n=n, n_ticks=n_ticks, plan_info=run.info,
        oracle_events=events_oracle,
        engine_events=engine_events(logs),
        oracle_counters=oracle_counts,
        engine_counters=expand_counters(logs),
        oracle_phase_counters=run.oracle_phase,
        engine_phase_counters=expand_fallback_counters(logs),
        oracle_config_id=run.oracle_cfg,
        engine_config_id=state_config_id(run.final),
        engine_metrics=telemetry_metrics.engine_metrics(logs),
        oracle_metrics=telemetry_metrics.oracle_metrics(
            oracle_counts, events_oracle),
        seconds=run.seconds,
    )


@dataclass
class VariantDiffResult:
    """Oracle vs engine under a ``Settings.protocol_variant`` message model.

    The oracle still runs the reference protocol; its counters are
    recomputed under the variant's wire accounting by
    ``variants.oracle`` (which also certifies the scenario is
    inside the variant's envelope — see ``VariantEnvelopeError``). The
    bit-identical contract covers events, per-tick transformed message
    counts, the final configuration id, and — for contested scenarios —
    the per-phase consensus counts including the ring-shaped fast votes.
    """

    variant: str
    n: int
    n_ticks: int
    contested: bool
    oracle_events: List[ViewEvent]
    engine_events: List[ViewEvent]
    oracle_counters: List[Dict[str, int]]
    engine_counters: List[Dict[str, int]]
    oracle_config_id: int
    engine_config_id: int
    # per-phase consensus streams, compared only for contested scenarios
    # (organic fast votes live in the vote class, not the px class)
    oracle_phase_counters: Optional[List[Dict[str, int]]] = None
    engine_phase_counters: Optional[List[Dict[str, int]]] = None
    engine_metrics: Optional[List] = None
    oracle_metrics: Optional[List] = None
    # host wall seconds of each side ("oracle", "plan", "referee" for the
    # host adversary engine, "engine" for the run and its host reads)
    seconds: Optional[Dict[str, float]] = None

    @property
    def oracle_message_total(self) -> int:
        """Total variant-model messages the oracle accounts for the run."""
        return sum(d["sent"] for d in self.oracle_counters)

    @property
    def engine_message_total(self) -> int:
        """Total messages the engine's expanded factors account."""
        return sum(d["sent"] for d in self.engine_counters)

    def first_divergence(self):
        """Earliest (tick, field) disagreement — None when bit-identical."""
        from rapid_tpu_torch.telemetry import forensics as fz

        candidates = [
            fz.events_divergence(self.engine_events, self.oracle_events),
            fz.counters_divergence(self.engine_counters,
                                   self.oracle_counters),
            fz.scalar_divergence("config_id", self.engine_config_id,
                                 self.oracle_config_id, tick=self.n_ticks),
        ]
        if self.oracle_phase_counters is not None:
            candidates.append(fz.counters_divergence(
                self.engine_phase_counters, self.oracle_phase_counters))
        div = fz.earliest(candidates)
        if div is None:
            return None
        return fz.build_report(div, engine_metrics=self.engine_metrics,
                               oracle_metrics=self.oracle_metrics,
                               events=self.oracle_events)

    def assert_identical(self, artifact: Optional[str] = None) -> None:
        """Raise ``DivergenceError`` at the first divergence; see
        ``DiffResult.assert_identical`` for the artifact contract."""
        report = self.first_divergence()
        if report is not None:
            _raise_divergence(report, artifact)


def run_variant_differential(
    n: int,
    crash_ticks: Dict[int, int],
    n_ticks: int,
    variant: str,
    settings: Optional[Settings] = None,
    contested: Optional[Tuple] = None,
    mesh=None,
    device="cuda",
) -> VariantDiffResult:
    """Replay a scenario through the variant engine and the variant-aware
    oracle accounting.

    With ``contested=None`` this is a crash scenario (``crash_ticks``
    maps slot -> crash tick, like ``run_differential``); with
    ``contested=(values, votes, delays)`` it is a scripted contested
    consensus instance (like ``run_fallback_differential``;
    ``crash_ticks`` must be empty). The engine runs with
    ``settings.protocol_variant = variant`` while the oracle's counters
    are transformed host-side by
    ``variants.oracle.variant_oracle_counters`` — proving the
    variant's decisions, config ids and per-tick message counts exactly.
    Raises ``variants.oracle.VariantEnvelopeError`` for
    scenarios where the variant legitimately behaves differently.
    """
    from rapid_tpu_torch.engine.step import require_scope
    from rapid_tpu_torch.variants import oracle as variants_oracle

    require_scope(mesh)
    dev = resolve_device(device)
    settings = (settings or Settings()).with_(protocol_variant=variant)
    uids = [uid_of(e) for e in default_endpoints(n)]

    if contested is not None:
        if crash_ticks:
            raise ValueError("contested variant scenarios are crash-free; "
                             "pass crash_ticks={}")
        values, votes, delays = contested
        base = run_fallback_differential(n, values, votes, delays, n_ticks,
                                         settings=settings, device=dev)
        o_tick, o_phase = variants_oracle.variant_oracle_counters(
            variant, n, {}, base.oracle_events, base.oracle_counters,
            base.oracle_phase_counters, uids, contested=True)
        return VariantDiffResult(
            variant=variant, n=n, n_ticks=n_ticks, contested=True,
            oracle_events=base.oracle_events,
            engine_events=base.engine_events,
            oracle_counters=o_tick,
            engine_counters=base.engine_counters,
            oracle_phase_counters=o_phase,
            engine_phase_counters=base.engine_phase_counters,
            oracle_config_id=base.oracle_config_id,
            engine_config_id=base.engine_config_id,
            engine_metrics=base.engine_metrics,
            oracle_metrics=base.oracle_metrics,
            seconds=base.seconds,
        )

    # --- crash scenario: run_differential plus the per-phase capture ----
    from rapid_tpu_torch.engine.state import state_config_id
    from rapid_tpu_torch.telemetry import metrics as telemetry_metrics

    run = _crash_runs(n, crash_ticks, n_ticks, settings, dev, mesh)
    o_tick, _ = variants_oracle.variant_oracle_counters(
        variant, n, dict(crash_ticks), run.events_oracle, run.oracle_counts,
        run.oracle_phase, uids, contested=False)
    logs = run.logs
    return VariantDiffResult(
        variant=variant, n=n, n_ticks=n_ticks, contested=False,
        oracle_events=run.events_oracle,
        engine_events=engine_events(logs),
        oracle_counters=o_tick,
        engine_counters=expand_counters(logs),
        oracle_config_id=run.oracle_cfg,
        engine_config_id=state_config_id(run.final),
        engine_metrics=telemetry_metrics.engine_metrics(logs),
        oracle_metrics=telemetry_metrics.oracle_metrics(
            run.oracle_counts, run.events_oracle),
        seconds=run.seconds,
    )


def run_churn_differential(
    n: int,
    capacity: int,
    n_ticks: int,
    joins: Optional[Dict[int, int]] = None,
    leaves: Optional[Dict[int, int]] = None,
    crashes: Optional[Dict[int, int]] = None,
    settings: Optional[Settings] = None,
    seed_slot: int = 0,
    node_ids: Optional[List[NodeId]] = None,
    device="cuda",
) -> ChurnDiffResult:
    """Replay a join/leave/crash scenario through planner, oracle, engine.

    Slots ``[0, n)`` boot as converged members; ``[n, capacity)`` are
    dormant joiner slots. ``joins[s]`` is the tick slot ``s`` calls
    ``Cluster.join(seed)``, ``leaves[s]`` the tick it calls
    ``leave_gracefully()``, ``crashes[s]`` its crash tick. The planner
    raises ``ChurnEnvelopeError`` for scenarios outside the bit-identical
    envelope *before* either simulation runs. ``node_ids`` overrides the
    initial members' NodeIds (default ``default_node_ids``) — tests use
    it to force a joiner's first NodeId draw to collide and exercise the
    UUID-retry redraw path on both sides. The engine runs on ``device``.
    """
    from rapid_tpu_torch.engine.churn import plan_churn
    from rapid_tpu_torch.engine.state import state_config_id

    dev = resolve_device(device)
    joins = dict(joins or {})
    leaves = dict(leaves or {})
    crashes = dict(crashes or {})
    settings = settings or Settings()
    endpoints = default_endpoints(capacity)
    if node_ids is None:
        node_ids = default_node_ids(n)
    elif len(node_ids) != n:
        raise ValueError(f"node_ids must cover the {n} initial members")
    node_ids = [NodeId.of(i) for i in node_ids]

    # --- plan: host protocol mirror, raises if out of envelope ----------
    t0 = time.perf_counter()
    plan = plan_churn(endpoints, n, node_ids, n_ticks, settings,
                      joins=joins, leaves=leaves, crashes=crashes,
                      seed_slot=seed_slot)

    # --- oracle side ----------------------------------------------------
    t1 = time.perf_counter()
    fault_model = CrashFault({endpoints[s]: t for s, t in crashes.items()}) \
        if crashes else HEALTHY
    network, clusters, recorders = boot_static_cluster(
        settings, endpoints[:n], node_ids, fault_model)
    # Pre-number every dormant slot so joiner events land on canonical
    # slot indices (the recorders share one slot_of dict).
    recorders[0]._slot_of.update(
        {endpoints[s]: s for s in range(n, capacity)})

    joiner_recorders: Dict[int, _Recorder] = {}
    cluster_of: Dict[int, Cluster] = dict(enumerate(clusters))
    for s in sorted(joins):
        cluster = Cluster(network, endpoints[s], settings)
        recorder = _Recorder(network, recorders[0]._slot_of)
        recorder.subscribe(cluster)
        cluster_of[s] = cluster
        joiner_recorders[s] = recorder
    # Host actions scheduled up front get the smallest scheduler handles,
    # so same-tick operations run in (tick, slot) order ahead of message
    # processing — the order the planner assumes.
    ops = sorted([(t, s, "join") for s, t in joins.items()]
                 + [(t, s, "leave") for s, t in leaves.items()])
    seed_ep = endpoints[seed_slot]
    for t, s, kind in ops:
        if kind == "join":
            network.at(t, lambda cl=cluster_of[s]: cl.join(seed_ep))
        else:
            network.at(t, lambda cl=cluster_of[s]: cl.leave_gracefully())
    run_oracle(network, n_ticks)

    # Reference stream: initial members that neither crash nor leave.
    alive = [s for s in range(n) if s not in crashes and s not in leaves]
    events_oracle = oracle_events(recorders, alive)
    reference = events_oracle

    # Leavers see a prefix of the reference (they vote on and apply their
    # own removal before the service stops).
    for s in leaves:
        if s in crashes or s >= n:
            continue
        seen = recorders[s].events
        assert seen == reference[:len(seen)], (
            f"leaver {s} saw a non-prefix stream: {seen}")
    # Joiners see the suffix after their wiring tick, once the boot
    # VIEW_CHANGE their service fires at creation is dropped.
    for s, recorder in joiner_recorders.items():
        if s in crashes:
            continue
        wired = plan.wired.get(s)
        assert wired is not None, f"joiner {s} never wired in the oracle run"
        seen = [e for e in recorder.events
                if not (e.kind == "view_change" and e.tick == wired)]
        expect = [e for e in reference if e.tick > wired]
        assert seen == expect[:len(seen)] and (
            len(seen) == len(expect) or s in leaves), (
            f"joiner {s} (wired {wired}) diverged: {seen} != {expect}")

    oracle_view = cluster_of[alive[0]].membership_service.view
    oracle_cfg = oracle_view.get_current_configuration_id()
    oracle_members = frozenset(
        recorders[0]._slot_of[e] for e in oracle_view.get_ring(0))
    t2 = time.perf_counter()

    # --- engine side ----------------------------------------------------
    uids = [uid_of(e) for e in endpoints]
    id_fp_sum = MembershipView(settings.K, node_ids, [])._id_fp_sum
    member0 = [True] * n + [False] * (capacity - n)
    final_state, logs = _run_shared(
        settings, dev, uids, id_fp_sum,
        [crashes.get(s) for s in range(capacity)], n_ticks, member=member0,
        id_fps=plan.id_fps, churn=plan.schedule)
    engine_members = frozenset(
        int(s) for s in np.nonzero(final_state.member.cpu().numpy())[0])
    seconds = {"plan": t1 - t0, "oracle": t2 - t1,
               "engine": time.perf_counter() - t2}

    from rapid_tpu_torch.telemetry import metrics as telemetry_metrics

    return ChurnDiffResult(
        engine_metrics=telemetry_metrics.engine_metrics(logs),
        n_initial=n, capacity=capacity, n_ticks=n_ticks,
        oracle_events=events_oracle,
        engine_events=engine_events(logs),
        plan_events=[ViewEvent(*e) for e in plan.events],
        oracle_config_id=oracle_cfg,
        engine_config_id=state_config_id(final_state),
        plan_config_id=plan.final_config_id,
        oracle_members=oracle_members,
        engine_members=engine_members,
        plan_members=plan.final_members,
        seconds=seconds,
    )


# ---------------------------------------------------------------------------
# adversarial differential: unscripted fault schedules, no planner envelope
# ---------------------------------------------------------------------------


@dataclass
class AdversaryDiffResult:
    """Oracle vs the per-slot adversary engine for one fault schedule.

    Under partitions the nodes legitimately see *different* event
    streams, so the comparison is per slot: every slot's engine stream
    (proposals, view changes, config ids) against the same slot's oracle
    recorder, plus total per-tick message counters, per-phase consensus
    counters, and every slot's final configuration id (meaningful for
    kicked and crashed nodes too — their views freeze where the protocol
    left them).
    """

    n: int
    n_ticks: int
    schedule: object
    oracle_events_by_slot: List[List[ViewEvent]]
    engine_events_by_slot: List[List[ViewEvent]]
    oracle_counters: List[Dict[str, int]]
    engine_counters: List[Dict[str, int]]
    oracle_phase_counters: List[Dict[str, int]]
    engine_phase_counters: List[Dict[str, int]]
    oracle_config_ids: List[int]
    engine_config_ids: List[int]
    engine_metrics: Optional[List] = None
    oracle_metrics: Optional[List] = None
    # host wall seconds of each side ("oracle", "plan", "referee" for the
    # host adversary engine, "engine" for the run and its host reads)
    seconds: Optional[Dict[str, float]] = None

    def first_divergence(self):
        """Earliest (tick, field) disagreement across all per-slot event
        streams, counters, phase counters and final per-slot config ids —
        None when bit-identical."""
        from rapid_tpu_torch.telemetry import forensics as fz

        candidates = [
            fz.counters_divergence(self.engine_counters,
                                   self.oracle_counters),
            fz.counters_divergence(self.engine_phase_counters,
                                   self.oracle_phase_counters),
        ]
        for s in range(self.n):
            candidates.append(fz.events_divergence(
                self.engine_events_by_slot[s],
                self.oracle_events_by_slot[s], prefix=f"slot{s}.events"))
            candidates.append(fz.scalar_divergence(
                f"slot{s}.config_id", self.engine_config_ids[s],
                self.oracle_config_ids[s], tick=self.n_ticks))
        div = fz.earliest(candidates)
        if div is None:
            return None
        events = max(self.oracle_events_by_slot, key=len, default=[])
        return fz.build_report(div, engine_metrics=self.engine_metrics,
                               oracle_metrics=self.oracle_metrics,
                               events=events)

    def assert_identical(self, artifact: Optional[str] = None) -> None:
        """Raise ``DivergenceError`` at the first divergence; see
        ``DiffResult.assert_identical`` for the artifact contract."""
        report = self.first_divergence()
        if report is not None:
            _raise_divergence(report, artifact)


def run_adversarial_differential(
    schedule,
    n_ticks: int,
    settings: Optional[Settings] = None,
) -> AdversaryDiffResult:
    """Replay an unscripted ``faults.AdversarySchedule`` through the
    oracle and the per-slot host adversary engine (host against host).

    Nothing scenario-shaped is screened: the schedule's crashes may
    straddle FD-interval boundaries, its link windows may partition the
    monitoring topology asymmetrically or flip-flop, and its scripted
    proposes may tie timers, fire mid-fast-count, or race coordinator
    ranks — ``faults.validate_schedule`` only checks genuine input
    validity. Both sides draw organic fallback jitter from identical
    per-slot rng streams seeded by ``schedule.seed``.
    """
    from rapid_tpu_torch.engine.adversary import AdversaryEngine
    from rapid_tpu_torch.engine.paxos import adversary_rngs
    from rapid_tpu_torch.faults import validate_schedule
    from rapid_tpu_torch.identity import id_fingerprint

    validate_schedule(schedule)
    settings = settings or Settings()
    n = schedule.n
    endpoints = default_endpoints(n)
    node_ids = default_node_ids(n)

    # --- oracle side ----------------------------------------------------
    t0 = time.perf_counter()
    network, clusters, recorders = boot_static_cluster(
        settings, endpoints, node_ids, schedule.fault_model(endpoints),
        rngs=adversary_rngs(schedule.seed, n))
    view0 = clusters[0].membership_service.view
    # Scripted proposes register after boot in schedule order — the same
    # handle order the engine replicates. ``fast_paxos`` resolves at fire
    # time so a propose after a view change lands on the live instance.
    for p in schedule.proposes:
        ordered = sorted((endpoints[s] for s in p.proposal),
                         key=view0.ring0_sort_key)
        network.at(p.tick,
                   lambda svc=clusters[p.slot].membership_service,
                   prop=ordered, d=p.delay_ticks:
                   svc.fast_paxos.propose(prop, recovery_delay_ticks=d))
    oracle_counts = run_oracle(network, n_ticks)
    oracle_phase = [dict(d) for d in network.consensus_history]
    oracle_cfgs = [c.membership_service.view.get_current_configuration_id()
                   for c in clusters]
    t1 = time.perf_counter()

    # --- engine side ----------------------------------------------------
    uids = [uid_of(e) for e in endpoints]
    id_fp_sum = sum(id_fingerprint(nid) for nid in node_ids) & ((1 << 64) - 1)
    engine = AdversaryEngine(schedule, uids, id_fp_sum, settings)
    run = engine.run(n_ticks)
    seconds = {"oracle": t1 - t0, "referee": time.perf_counter() - t1}

    from rapid_tpu_torch.telemetry import metrics as telemetry_metrics

    all_oracle_events = sorted(
        {e for r in recorders for e in r.events},
        key=lambda e: (e.tick, e.kind))
    return AdversaryDiffResult(
        n=n, n_ticks=n_ticks, schedule=schedule,
        oracle_events_by_slot=[list(r.events) for r in recorders],
        engine_events_by_slot=[
            [ViewEvent(tick=t, kind=k, config_id=c, slots=slots)
             for t, k, c, slots in evs]
            for evs in run.events_by_slot],
        oracle_counters=oracle_counts,
        engine_counters=run.tick_history,
        oracle_phase_counters=oracle_phase,
        engine_phase_counters=run.phase_history,
        oracle_config_ids=oracle_cfgs,
        engine_config_ids=run.config_ids,
        engine_metrics=run.metrics(),
        oracle_metrics=telemetry_metrics.oracle_metrics(
            oracle_counts, all_oracle_events),
        seconds=seconds,
    )


def run_receiver_differential(
    schedule,
    n_ticks: int,
    settings: Optional[Settings] = None,
    device="cuda",
) -> AdversaryDiffResult:
    """Replay a link-fault ``faults.AdversarySchedule`` through the host
    per-slot adversary engine and the per-receiver engine on ``device``
    (``engine.receiver``, under ``settings.rx_kernel``'s carry).

    This is the fidelity proof for fleet per-receiver members: the device
    side runs the whole scenario with per-slot views, an explicit wire
    and link reachability evaluated per (sender, receiver) edge at
    delivery, and must reproduce the host
    referee's per-slot event streams, per-tick counters, per-phase
    consensus traffic and per-slot final config ids bit-identically.
    Campaign spot checks call this as belt-and-suspenders; the campaign
    result itself is device-exact without it.

    Delay rules are in-envelope: the schedule's ``DelayRule`` set lowers
    to the device delivery ring (depth ``settings.delivery_ring_depth``,
    budget-checked here before anything allocates) and the host referee
    evaluates the identical tick-quantized send-time delay, so delayed,
    jittered and reordered deliveries are part of the bit-exactness
    contract, not an approximation.

    Scripted proposes are outside the per-receiver envelope (fleet
    lowering keeps those members on the shared-state path), and a sticky
    device flag raises ``receiver.ReceiverEnvelopeError`` rather than
    letting an out-of-envelope run masquerade as exact.
    """
    from rapid_tpu_torch.engine import receiver as receiver_mod
    from rapid_tpu_torch.engine.adversary import AdversaryEngine
    from rapid_tpu_torch.engine.state import link_faults
    from rapid_tpu_torch.faults import validate_schedule
    from rapid_tpu_torch.identity import id_fingerprint

    dev = resolve_device(device)
    settings = settings or Settings()
    validate_schedule(schedule, ring_depth=settings.delivery_ring_depth)
    if schedule.proposes:
        raise ValueError("per-receiver mode does not support scripted "
                         "proposes; use run_adversarial_differential")
    n = schedule.n
    uids = [uid_of(e) for e in default_endpoints(n)]
    id_fp_sum = sum(id_fingerprint(nid)
                    for nid in default_node_ids(n)) & ((1 << 64) - 1)

    # --- host referee ---------------------------------------------------
    t0 = time.perf_counter()
    host = AdversaryEngine(schedule, uids, id_fp_sum, settings).run(n_ticks)
    t1 = time.perf_counter()

    # --- device side ----------------------------------------------------
    rs = receiver_mod.init_receiver_state(uids, id_fp_sum, settings,
                                          seed=schedule.seed, device=dev)
    faults = link_faults(schedule.crash_tick_array().tolist(),
                         schedule.windows, rs.member.shape[0],
                         delays=schedule.delays, delay_seed=schedule.seed,
                         device=dev)
    final, logs = receiver_mod.receiver_simulate(rs, faults, n_ticks,
                                                 settings)
    receiver_mod.check_flags(final.flags)
    run = receiver_mod.receiver_run_payload(final, logs, n, n_ticks)
    seconds = {"referee": t1 - t0, "engine": time.perf_counter() - t1}

    def as_view_events(evs):
        return [[ViewEvent(tick=t, kind=k, config_id=c, slots=slots)
                 for t, k, c, slots in slot_evs] for slot_evs in evs]

    return AdversaryDiffResult(
        n=n, n_ticks=n_ticks, schedule=schedule,
        oracle_events_by_slot=as_view_events(host.events_by_slot),
        engine_events_by_slot=as_view_events(run.events_by_slot),
        oracle_counters=host.tick_history,
        engine_counters=run.tick_history,
        oracle_phase_counters=host.phase_history,
        engine_phase_counters=run.phase_history,
        oracle_config_ids=host.config_ids,
        engine_config_ids=run.config_ids,
        engine_metrics=run.metrics(),
        oracle_metrics=host.metrics(),
        seconds=seconds,
    )


# ---------------------------------------------------------------------------
# lineage differential: phase-attributed span streams, oracle vs engine
# ---------------------------------------------------------------------------

#: Scenario families the lineage differential covers.
LINEAGE_FAMILIES = ("steady", "crash_burst", "delay", "contested")


@dataclass
class LineageDiffResult:
    """Oracle vs engine lineage span streams for one scenario family.

    Lineage spans are *derived* data — the fold runs independently over
    the oracle's counter/event timeline and the engine's expanded
    ``StepLog`` factors (or the adversary referee's counter streams for
    the delay family), and the comparison is the
    ``telemetry.lineage.comparable`` projection of every
    span: window boundaries, ``ticks_to_view_change``, the fallback
    flag, every oracle-observable milestone tick and all five phase
    durations. Engine-only fields (fallback timer arm ticks, critical
    path) are excluded by the projection, not fudged to match.
    """

    family: str
    n: int
    n_ticks: int
    oracle_spans: Dict[str, List[Dict[str, object]]]
    engine_spans: Dict[str, List[Dict[str, object]]]

    def first_divergence(self) -> Optional[str]:
        """Human-readable description of the earliest span disagreement,
        or None when every stream is bit-identical under the comparable
        projection."""
        from rapid_tpu_torch.telemetry.lineage import comparable

        for label in sorted(self.oracle_spans):
            oracle = [comparable(s) for s in self.oracle_spans[label]]
            engine = [comparable(s) for s in self.engine_spans.get(label, [])]
            if len(oracle) != len(engine):
                return (f"{label}: engine has {len(engine)} spans, "
                        f"oracle has {len(oracle)}")
            for i, (e, o) in enumerate(zip(engine, oracle)):
                if e != o:
                    keys = [k for k in o if e.get(k) != o.get(k)]
                    return (f"{label}: span {i} differs on {keys}: "
                            f"engine={e} oracle={o}")
        return None

    def assert_identical(self) -> None:
        div = self.first_divergence()
        if div is not None:
            raise AssertionError("lineage divergence: " + div)


def _lineage_crash_burst(n: int) -> Dict[int, int]:
    return {max(1, n // 5): 5, max(2, n // 3): 5, n - 2: 7}


def run_lineage_differential(
    family: str,
    n: int,
    n_ticks: int = 200,
    settings: Optional[Settings] = None,
    seed: int = 5,
    device="cuda",
) -> LineageDiffResult:
    """Fold lineage spans independently on oracle and engine sides.

    Families (see :data:`LINEAGE_FAMILIES`):

    - ``steady``: healthy cluster, no faults — both sides must fold zero
      spans (the empty stream is part of the contract);
    - ``crash_burst``: a three-slot crash burst drives organic cut
      detection, announce and fast-quorum decide;
    - ``delay``: a crash plus a ``DelayRule`` over a slot block, folded
      per slot over the adversary referee's per-slot event streams;
    - ``contested``: a scripted two-way vote split forces the classic
      fallback, covering the 1a/1b/2a/2b milestones.

    Oracle spans always come from :func:`counter_phase_columns` over
    ``SimNetwork`` history (``tick_history`` + ``consensus_history`` +
    recorder events); engine spans come from
    :func:`engine_phase_columns` over raw ``StepLog`` factor logs for
    the shared-scan families, and from the adversary engine's counter
    streams for the delay family.
    """
    from rapid_tpu_torch.telemetry import lineage as lineage_mod

    dev = resolve_device(device)
    settings = settings or Settings()
    if family not in LINEAGE_FAMILIES:
        raise ValueError(f"unknown lineage family {family!r}; "
                         f"expected one of {LINEAGE_FAMILIES}")

    if family in ("steady", "crash_burst"):
        crash_ticks = {} if family == "steady" else _lineage_crash_burst(n)
        base = _crash_runs(n, crash_ticks, n_ticks, settings, dev)
        return LineageDiffResult(
            family=family, n=n, n_ticks=n_ticks,
            **_lineage_spans(base, lineage_mod))

    if family == "contested":
        # Two-way split: half vote to remove slot 0, half slot 1; no fast
        # quorum forms, slot 0's timer fires and the classic round decides.
        values = [[0], [1]]
        votes = {s: (6, s % 2) for s in range(n)}
        delays = {s: (10 if s == 0 else 100) for s in range(n)}
        base = _contested_runs(n, values, votes, delays, min(n_ticks, 40),
                               settings, dev)
        return LineageDiffResult(family=family, n=n,
                                 n_ticks=min(n_ticks, 40),
                                 **_lineage_spans(base, lineage_mod))
    # family == "delay"
    from rapid_tpu_torch.faults import AdversarySchedule, DelayRule

    block = max(2, n // 8)
    schedule = AdversarySchedule(
        n=n,
        crashes=((n - 1, 11),),
        delays=(DelayRule(src_slots=frozenset(range(block)),
                          dst_slots=frozenset(range(block, n // 2)),
                          delay_ticks=2),),
        seed=seed)
    base = run_adversarial_differential(schedule, n_ticks, settings)
    oracle_spans = {}
    engine_spans = {}
    for s in range(n):
        o_cols = lineage_mod.counter_phase_columns(
            base.oracle_counters, base.oracle_phase_counters,
            base.oracle_events_by_slot[s])
        e_cols = lineage_mod.counter_phase_columns(
            base.engine_counters, base.engine_phase_counters,
            base.engine_events_by_slot[s])
        oracle_spans[f"slot{s}"] = lineage_mod.fold_spans(o_cols,
                                                          start_tick=0)
        engine_spans[f"slot{s}"] = lineage_mod.fold_spans(e_cols,
                                                          start_tick=0)
    return LineageDiffResult(family=family, n=n, n_ticks=n_ticks,
                             oracle_spans=oracle_spans,
                             engine_spans=engine_spans)


def _lineage_spans(base, lineage_mod) -> Dict[str, Dict[str, list]]:
    """Spans folded apart from the oracle's counters and events of a
    ``_crash_runs`` or ``_contested_runs`` result and from its engine's
    logs."""
    oracle_cols = lineage_mod.counter_phase_columns(
        base.oracle_counts, base.oracle_phase, base.events_oracle)
    engine_cols = lineage_mod.engine_phase_columns(base.logs)
    return {"oracle_spans": {"all": lineage_mod.fold_spans(
                oracle_cols, start_tick=0)},
            "engine_spans": {"all": lineage_mod.fold_spans(
                engine_cols, start_tick=0)}}


def _contested_runs(n, values, votes, delays, n_ticks, settings, dev):
    """One scripted contested instance through the planner (which checks
    the envelope first), the oracle and the shared engine on ``dev``."""
    from rapid_tpu_torch.engine.paxos import plan_fallback

    endpoints = default_endpoints(n)
    node_ids = default_node_ids(n)
    uids = np.asarray([uid_of(e) for e in endpoints], np.uint64)

    # --- plan: validates the envelope, predicts the outcome -------------
    sched, info = plan_fallback(n, values, votes, delays, settings,
                                uids=uids)

    # --- oracle side (crash-free: contention comes from the script) -----
    t0 = time.perf_counter()
    network, clusters, recorders = boot_static_cluster(
        settings, endpoints, node_ids)
    # Proposals reach FastPaxos.propose sorted by the ring-0 key, exactly
    # as _handle_batched_alerts orders a cut-detector proposal.
    view0 = clusters[0].membership_service.view
    ordered = [sorted((endpoints[s] for s in val), key=view0.ring0_sort_key)
               for val in values]
    # Registration in (tick, slot) order gives same-tick proposes the
    # scheduler-handle order the planner and engine assume.
    for tick, s in sorted((vt, vs) for vs, (vt, _) in votes.items()):
        pid = votes[s][1]
        network.at(tick, lambda svc=clusters[s].membership_service,
                   prop=ordered[pid], d=delays[s]:
                   svc.fast_paxos.propose(prop, recovery_delay_ticks=d))
    oracle_counts = run_oracle(network, n_ticks)
    oracle_phase = [dict(d) for d in network.consensus_history]
    removed = set(values[int(info["winner"])]) if info["winner"] is not None \
        and int(info["winner"]) >= 0 else set()
    survivors = [s for s in range(n) if s not in removed]
    events_oracle = oracle_events(recorders, survivors)
    oracle_cfg = clusters[survivors[0]].membership_service.view \
        .get_current_configuration_id()
    t1 = time.perf_counter()

    # --- engine side ----------------------------------------------------
    final, logs = _run_shared(settings, dev, uids, view0._id_fp_sum,
                              [None] * n, n_ticks, fallback=sched)
    return SimpleNamespace(
        info=info, oracle_counts=oracle_counts, oracle_phase=oracle_phase,
        events_oracle=events_oracle, oracle_cfg=oracle_cfg, final=final,
        logs=logs, seconds={"oracle": t1 - t0,
                            "engine": time.perf_counter() - t1})
