"""The membership protocol state machine (host oracle).

Mirrors MembershipService.java:73-754 on virtual time:

- single entry point ``handle_message(request, reply)`` (reference :178-200);
- join phase 1 at a seed (:207-228) and phase 2 at gatekeepers (:236-293)
  with parked replies released only after consensus (:723-748);
- batched alerts -> validity filter -> cut detector -> proposal ->
  FastPaxos (:304-358), with the announced-proposal latch (:322);
- decideViewChange applies the cut: ring add/delete, metadata update, event
  subscriptions, KICKED detection, fresh FastPaxos + cut detector state, FD
  re-subscription (:389-448);
- alert batching with a one-window quiescence flush (:617-641);
- edge-failure notifications from the pluggable FD (:476-499), leave
  handling (:376-381), probes (:453-456).

Timers are ticks on the shared deterministic scheduler; one tick equals the
reference's 100 ms batching window (see Settings).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from rapid_tpu_torch.events import ClusterEvents, ClusterStatusChange, NodeStatusChange
from rapid_tpu_torch.oracle.cut_detector import MultiNodeCutDetector
from rapid_tpu_torch.oracle.interfaces import (
    IBroadcaster,
    IEdgeFailureDetectorFactory,
    IMessagingClient,
    IScheduler,
    UnicastToAllBroadcaster,
)
from rapid_tpu_torch.oracle.membership_view import MembershipView
from rapid_tpu_torch.oracle.metadata import MetadataManager
from rapid_tpu_torch.oracle.paxos import FastPaxos
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import (
    AlertMessage,
    BatchedAlertMessage,
    CONSENSUS_MESSAGE_TYPES,
    EdgeStatus,
    Endpoint,
    JoinMessage,
    JoinResponse,
    JoinStatusCode,
    LeaveMessage,
    Metadata,
    NodeId,
    PreJoinMessage,
    ProbeMessage,
    ProbeResponse,
    ProbeStatus,
    Response,
)


class MissingJoinerIdError(RuntimeError):
    """A decided proposal contains a joiner whose UP alert (carrying its
    NodeId) this node never received. The reference crashes here too
    (`assert joinerUuid.containsKey(node)`, MembershipService.java:409);
    the simulation surfaces it as a node failure."""


class MembershipService:
    def __init__(self, my_addr: Endpoint, cut_detector: MultiNodeCutDetector,
                 view: MembershipView, settings: Settings,
                 client: IMessagingClient, scheduler: IScheduler,
                 fd_factory: IEdgeFailureDetectorFactory,
                 metadata_map: Optional[Dict[Endpoint, Metadata]] = None,
                 subscriptions: Optional[Dict[ClusterEvents, List[Callable]]] = None,
                 broadcaster: Optional[IBroadcaster] = None,
                 rng=None) -> None:
        self.my_addr = my_addr
        self.settings = settings
        self.view = view
        self.cut_detector = cut_detector
        self.client = client
        self.scheduler = scheduler
        self.fd_factory = fd_factory
        self.rng = rng
        self.metadata_manager = MetadataManager()
        if metadata_map:
            self.metadata_manager.add_metadata(metadata_map)
        # No recipient shuffle (the reference shuffles only to spread network
        # load, UnicastToAllBroadcaster.java:56-62; per-receiver semantics are
        # unaffected and an unshuffled order keeps runs reproducible).
        self.broadcaster = broadcaster or UnicastToAllBroadcaster(client, None)
        self.subscriptions: Dict[ClusterEvents, List[Callable]] = {
            e: [] for e in ClusterEvents
        }
        if subscriptions:
            for event, callbacks in subscriptions.items():
                self.subscriptions[event].extend(callbacks)

        # joiners parked awaiting consensus: endpoint -> [reply callbacks]
        self._joiners_to_respond_to: Dict[Endpoint, List[Callable]] = {}
        self._joiner_uuid: Dict[Endpoint, NodeId] = {}
        self._joiner_metadata: Dict[Endpoint, Metadata] = {}

        # alert batching
        self._send_queue: List[AlertMessage] = []
        self._last_enqueue_tick = -1

        self._announced_proposal = False
        self._stopped = False
        self._fd_jobs: List[object] = []
        self._fd_instances: List[Callable[[], None]] = []

        self.broadcaster.set_membership(self.view.get_ring(0))
        self.fast_paxos = self._new_fast_paxos()
        self._create_failure_detectors()
        self._batcher_job = self._schedule_periodic(
            settings.batching_window_ticks, self._alert_batcher_tick
        )

        # Initial VIEW_CHANGE callbacks: start/join completed (ref :162-168).
        initial = ClusterStatusChange(
            self.view.get_current_configuration_id(),
            tuple(self.view.get_ring(0)),
            tuple(NodeStatusChange(n, EdgeStatus.UP,
                                   tuple(self.metadata_manager.get(n).items()))
                  for n in self.view.get_ring(0)),
        )
        self._fire(ClusterEvents.VIEW_CHANGE, initial)

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------

    def _schedule_periodic(self, interval: int, fn: Callable[[], None]) -> dict:
        """Periodic task aligned to global tick multiples of ``interval``, so
        every node's FD/batcher fires on the same ticks — the same global
        rounds the engines use."""
        job = {"cancelled": False}

        def run():
            if job["cancelled"] or self._stopped:
                return
            fn()
            self.scheduler.schedule(interval, run)

        now = self.scheduler.now()
        self.scheduler.schedule(interval - (now % interval), run)
        return job

    def _fire(self, event: ClusterEvents, change: ClusterStatusChange) -> None:
        for callback in self.subscriptions[event]:
            callback(change)

    def _new_fast_paxos(self) -> FastPaxos:
        return FastPaxos(
            self.my_addr,
            self.view.get_current_configuration_id(),
            self.view.get_membership_size(),
            self.client,
            self.broadcaster,
            self.scheduler,
            self._decide_view_change,
            fallback_base_delay_ticks=self.settings.fallback_base_delay_ticks,
            tick_ms=self.settings.tick_ms,
            rng=self.rng,
        )

    # ------------------------------------------------------------------
    # message entry point
    # ------------------------------------------------------------------

    def handle_message(self, msg, reply: Callable[[object], None]) -> None:
        if self._stopped:
            return
        if isinstance(msg, PreJoinMessage):
            self._handle_pre_join(msg, reply)
        elif isinstance(msg, JoinMessage):
            self._handle_join_phase2(msg, reply)
        elif isinstance(msg, BatchedAlertMessage):
            self._handle_batched_alerts(msg)
            reply(Response())
        elif isinstance(msg, CONSENSUS_MESSAGE_TYPES):
            self.fast_paxos.handle_messages(msg)
            reply(Response())
        elif isinstance(msg, LeaveMessage):
            self._edge_failure_notification(
                msg.sender, self.view.get_current_configuration_id()
            )
            reply(Response())
        elif isinstance(msg, ProbeMessage):
            reply(ProbeResponse(ProbeStatus.OK))
        else:
            raise TypeError(f"Unidentified request type {type(msg)}")

    # ------------------------------------------------------------------
    # join protocol (server side)
    # ------------------------------------------------------------------

    def _handle_pre_join(self, msg: PreJoinMessage, reply) -> None:
        """Phase 1 at the seed (MembershipService.java:207-228)."""
        status = self.view.is_safe_to_join(msg.sender, msg.node_id)
        endpoints: Tuple[Endpoint, ...] = ()
        if status in (JoinStatusCode.SAFE_TO_JOIN,
                      JoinStatusCode.HOSTNAME_ALREADY_IN_RING):
            endpoints = tuple(self.view.get_expected_observers_of(msg.sender))
        reply(JoinResponse(
            sender=self.my_addr,
            status_code=status,
            configuration_id=self.view.get_current_configuration_id(),
            endpoints=endpoints,
        ))

    def _handle_join_phase2(self, msg: JoinMessage, reply) -> None:
        """Phase 2 at a gatekeeper (MembershipService.java:236-293)."""
        current_configuration = self.view.get_current_configuration_id()
        if current_configuration == msg.configuration_id:
            # Park the reply; enqueue an UP alert carrying the joiner identity.
            self._joiners_to_respond_to.setdefault(msg.sender, []).append(reply)
            self._enqueue_alert(AlertMessage(
                edge_src=self.my_addr,
                edge_dst=msg.sender,
                edge_status=EdgeStatus.UP,
                configuration_id=current_configuration,
                ring_numbers=msg.ring_numbers,
                node_id=msg.node_id,
                metadata=msg.metadata,
            ))
            return
        # Configuration changed between phases 1 and 2.
        configuration = self.view.get_configuration()
        if self.view.is_host_present(msg.sender) and \
                self.view.is_identifier_present(msg.node_id):
            # The cluster already added the joiner: stream it the config.
            all_md = self.metadata_manager.get_all_metadata()
            reply(JoinResponse(
                sender=self.my_addr,
                status_code=JoinStatusCode.SAFE_TO_JOIN,
                configuration_id=configuration.get_configuration_id(),
                endpoints=configuration.endpoints,
                identifiers=configuration.node_ids,
                metadata=tuple((k, tuple(v.items())) for k, v in all_md.items()),
            ))
        else:
            reply(JoinResponse(
                sender=self.my_addr,
                status_code=JoinStatusCode.CONFIG_CHANGED,
                configuration_id=configuration.get_configuration_id(),
            ))

    # ------------------------------------------------------------------
    # alerts -> cut detection -> consensus
    # ------------------------------------------------------------------

    def _filter_alert(self, alert: AlertMessage, config_id: int) -> bool:
        """Validity filter (MembershipService.java:648-679)."""
        if alert.configuration_id != config_id:
            return False
        present = self.view.is_host_present(alert.edge_dst)
        if alert.edge_status == EdgeStatus.UP and present:
            return False
        if alert.edge_status == EdgeStatus.DOWN and not present:
            return False
        return True

    def _handle_batched_alerts(self, batch: BatchedAlertMessage) -> None:
        """MembershipService.java:304-358."""
        if self._announced_proposal:
            return
        config_id = self.view.get_current_configuration_id()
        proposal: Dict[Endpoint, None] = {}
        for alert in batch.messages:
            if not self._filter_alert(alert, config_id):
                continue
            if alert.edge_status == EdgeStatus.UP:
                # Stash joiner identity for the eventual ring add (ref :681-689).
                self._joiner_uuid[alert.edge_dst] = alert.node_id
                self._joiner_metadata[alert.edge_dst] = dict(alert.metadata)
            for node in self.cut_detector.aggregate_for_proposal(alert):
                proposal[node] = None
        for node in self.cut_detector.invalidate_failing_edges(self.view):
            proposal[node] = None

        if proposal:
            self._announced_proposal = True
            change = ClusterStatusChange(
                config_id, tuple(self.view.get_ring(0)),
                tuple(self._status_change(n) for n in proposal),
            )
            self._fire(ClusterEvents.VIEW_CHANGE_PROPOSAL, change)
            ordered = sorted(proposal, key=self.view.ring0_sort_key)
            self.fast_paxos.propose(ordered)

    def _status_change(self, node: Endpoint) -> NodeStatusChange:
        status = EdgeStatus.DOWN if self.view.is_host_present(node) else EdgeStatus.UP
        return NodeStatusChange(node, status,
                                tuple(self.metadata_manager.get(node).items()))

    # ------------------------------------------------------------------
    # view change application
    # ------------------------------------------------------------------

    def _decide_view_change(self, proposal: List[Endpoint]) -> None:
        """MembershipService.java:389-448."""
        self._cancel_failure_detectors()

        status_changes = []
        for node in proposal:
            if self.view.is_host_present(node):
                self.view.ring_delete(node)
                status_changes.append(NodeStatusChange(
                    node, EdgeStatus.DOWN,
                    tuple(self.metadata_manager.get(node).items())))
                self.metadata_manager.remove_node(node)
            else:
                if node not in self._joiner_uuid:
                    raise MissingJoinerIdError(
                        f"{self.my_addr} decided on joiner {node} without its id")
                node_id = self._joiner_uuid.pop(node)
                self.view.ring_add(node, node_id)
                metadata = self._joiner_metadata.pop(node, {})
                if metadata:
                    self.metadata_manager.add_metadata({node: metadata})
                status_changes.append(NodeStatusChange(
                    node, EdgeStatus.UP, tuple(metadata.items())))

        configuration_id = self.view.get_current_configuration_id()
        change = ClusterStatusChange(
            configuration_id, tuple(self.view.get_ring(0)), tuple(status_changes)
        )
        self._fire(ClusterEvents.VIEW_CHANGE, change)

        # Reset for the next round.
        self.cut_detector.clear()
        self._announced_proposal = False
        self.fast_paxos = self._new_fast_paxos()
        self.broadcaster.set_membership(self.view.get_ring(0))

        if self.view.is_host_present(self.my_addr):
            self._create_failure_detectors()
        else:
            self._fire(ClusterEvents.KICKED, change)
            self.stop()

        self._respond_to_joiners(proposal)

    def _respond_to_joiners(self, proposal: List[Endpoint]) -> None:
        """MembershipService.java:723-748."""
        configuration = self.view.get_configuration()
        all_md = self.metadata_manager.get_all_metadata()
        response = JoinResponse(
            sender=self.my_addr,
            status_code=JoinStatusCode.SAFE_TO_JOIN,
            configuration_id=configuration.get_configuration_id(),
            endpoints=configuration.endpoints,
            identifiers=configuration.node_ids,
            metadata=tuple((k, tuple(v.items())) for k, v in all_md.items()),
        )
        for node in proposal:
            for reply in self._joiners_to_respond_to.pop(node, []):
                reply(response)

    # ------------------------------------------------------------------
    # failure detection + alert batching
    # ------------------------------------------------------------------

    def _edge_failure_notification(self, subject: Endpoint, configuration_id: int) -> None:
        """MembershipService.java:476-499."""
        if configuration_id != self.view.get_current_configuration_id():
            return
        self._enqueue_alert(AlertMessage(
            edge_src=self.my_addr,
            edge_dst=subject,
            edge_status=EdgeStatus.DOWN,
            configuration_id=configuration_id,
            ring_numbers=tuple(self.view.get_ring_numbers(self.my_addr, subject)),
        ))

    def _enqueue_alert(self, msg: AlertMessage) -> None:
        self._last_enqueue_tick = self.scheduler.now()
        self._send_queue.append(msg)

    def _alert_batcher_tick(self) -> None:
        """Flush once the queue has been quiescent for one batching window
        (MembershipService.java:617-641)."""
        if not self._send_queue or self._last_enqueue_tick < 0:
            return
        if self.scheduler.now() - self._last_enqueue_tick \
                < self.settings.batching_window_ticks:
            return
        messages = tuple(self._send_queue)
        self._send_queue.clear()
        self.broadcaster.broadcast(BatchedAlertMessage(self.my_addr, messages))

    def _create_failure_detectors(self) -> None:
        """One FD per unique subject (MembershipService.java:701-711; the
        reference schedules one job per ring entry — duplicates of the same
        subject behave identically, so they are deduplicated here)."""
        config_id = self.view.get_current_configuration_id()
        subjects = list(dict.fromkeys(self.view.get_subjects_of(self.my_addr)))
        for subject in subjects:
            notify = (lambda s=subject, c=config_id:
                      self._edge_failure_notification(s, c))
            instance = self.fd_factory.create_instance(subject, notify)
            self._fd_instances.append(instance)
            job = self._schedule_periodic_fd(instance)
            self._fd_jobs.append(job)

    def _schedule_periodic_fd(self, instance: Callable[[], None]) -> dict:
        return self._schedule_periodic(self.settings.fd_interval_ticks, instance)

    def _cancel_failure_detectors(self) -> None:
        for job in self._fd_jobs:
            job["cancelled"] = True
        self._fd_jobs.clear()
        self._fd_instances.clear()

    # ------------------------------------------------------------------
    # public API surface (used by the Cluster facade)
    # ------------------------------------------------------------------

    def get_membership_view(self) -> List[Endpoint]:
        return self.view.get_ring(0)

    def get_membership_size(self) -> int:
        return self.view.get_membership_size()

    def get_configuration_id(self) -> int:
        return self.view.get_current_configuration_id()

    def get_metadata(self) -> Dict[Endpoint, Metadata]:
        return self.metadata_manager.get_all_metadata()

    def register_subscription(self, event: ClusterEvents,
                              callback: Callable[[ClusterStatusChange], None]) -> None:
        self.subscriptions[event].append(callback)

    def leave(self) -> None:
        """Proactively trigger DOWN alerts at our observers
        (MembershipService.java:549-569)."""
        try:
            observers = self.view.get_observers_of(self.my_addr)
        except Exception:
            return  # already removed
        for observer in observers:
            self.client.send_message_best_effort(
                observer, LeaveMessage(self.my_addr))

    def stop(self) -> None:
        self._stopped = True
        self._cancel_failure_detectors()
        self._batcher_job["cancelled"] = True
