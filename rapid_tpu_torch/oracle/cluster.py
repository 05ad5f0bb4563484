"""Cluster facade: bootstrapping, joining, leaving simulated nodes.

Mirrors the reference public API (Cluster.java:70-507):

- ``Cluster.start()`` bootstraps a one-node cluster (ref :259-284);
- ``Cluster.join(seed)`` runs the two-phase bootstrap with up to 5 retries,
  refreshing the NodeId on UUID_ALREADY_IN_RING and treating
  HOSTNAME_ALREADY_IN_RING as "stream me the configuration" via a sentinel
  config id of -1 (ref :307-441);
- ``get_memberlist / get_membership_size / get_cluster_metadata /
  register_subscription / leave_gracefully / shutdown`` (ref :98-164).

The reference's join blocks a thread; on virtual time it is a state machine
advanced by ticks: start a join, run the simulation, and observe
``cluster.is_active`` / ``ClusterEvents.VIEW_CHANGE``.
"""
from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional

from rapid_tpu_torch.events import ClusterEvents, ClusterStatusChange
from rapid_tpu_torch.oracle.cut_detector import MultiNodeCutDetector
from rapid_tpu_torch.oracle.failure_detector import PingPongFailureDetectorFactory
from rapid_tpu_torch.oracle.interfaces import IEdgeFailureDetectorFactory
from rapid_tpu_torch.oracle.membership_view import MembershipView
from rapid_tpu_torch.oracle.service import MembershipService
from rapid_tpu_torch.oracle.simulation import SimMessagingClient, SimNetwork, SimServer
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import (
    Endpoint,
    JoinMessage,
    JoinResponse,
    JoinStatusCode,
    Metadata,
    NodeId,
    PreJoinMessage,
)


class JoinError(RuntimeError):
    pass


def default_rng(settings: Settings, listen_address) -> random.Random:
    """The rng a ``Cluster`` built without one draws node ids from, for
    ``listen_address`` (an ``Endpoint`` or a ``(hostname, port)`` pair);
    the churn planner draws a joiner's ids from it too.

    It is seeded from ``hash((settings.seed, "host:port"))``, and Python
    salts ``str`` hashes per process: the same endpoint draws the same
    node ids in two processes only under the same ``PYTHONHASHSEED``."""
    address = str(Endpoint.of(listen_address))
    return random.Random(hash((settings.seed, address)) & 0xFFFFFFFF)


class Cluster:
    """One simulated cluster member."""

    def __init__(self, network: SimNetwork, listen_address: Endpoint,
                 settings: Optional[Settings] = None,
                 metadata: Optional[Metadata] = None,
                 fd_factory: Optional[IEdgeFailureDetectorFactory] = None,
                 rng: Optional[random.Random] = None) -> None:
        self.network = network
        self.listen_address = listen_address
        self.settings = settings or network.settings
        self.metadata = dict(metadata or {})
        self.rng = rng or default_rng(self.settings, listen_address)
        self.server = SimServer(network, listen_address)
        self.client = SimMessagingClient(network, listen_address)
        self.fd_factory = fd_factory or PingPongFailureDetectorFactory(
            network, listen_address,
            self.settings.fd_failure_threshold,
            self.settings.fd_bootstrap_tolerance,
        )
        self.membership_service: Optional[MembershipService] = None
        self._subscriptions: Dict[ClusterEvents, List[Callable]] = {
            e: [] for e in ClusterEvents
        }
        self._join_state: Optional[dict] = None
        self.join_failed = False

    # -- configuration before the service starts -----------------------------

    def register_subscription(self, event: ClusterEvents,
                              callback: Callable[[ClusterStatusChange], None]) -> None:
        if self.membership_service is not None:
            self.membership_service.register_subscription(event, callback)
        else:
            self._subscriptions[event].append(callback)

    # -- bootstrap -----------------------------------------------------------

    @property
    def is_active(self) -> bool:
        return self.membership_service is not None

    def _fresh_node_id(self) -> NodeId:
        return NodeId(self.rng.getrandbits(64), self.rng.getrandbits(64))

    def start(self) -> "Cluster":
        """Bootstrap a one-node cluster (the seed). Cluster.java:259-284."""
        node_id = self._fresh_node_id()
        view = MembershipView(self.settings.K, [node_id], [self.listen_address])
        self._wire_service(view, {self.listen_address: self.metadata}
                           if self.metadata else {})
        return self

    def join(self, seed_address: Endpoint) -> "Cluster":
        """Begin the two-phase join; completes asynchronously over ticks
        (Cluster.java:307-348)."""
        self.server.start()
        self._join_state = {
            "seed": seed_address,
            "attempt": 0,
            "node_id": self._fresh_node_id(),
            "done": False,
        }
        self._join_attempt()
        return self

    def _join_attempt(self) -> None:
        state = self._join_state
        assert state is not None
        if state["done"]:
            return
        if state["attempt"] >= self.settings.join_attempts:
            self.join_failed = True
            self.server.shutdown()
            return
        state["attempt"] += 1
        attempt_no = state["attempt"]

        # Per-attempt timeout drives the retry loop (the reference blocks on
        # futures with a join timeout; Settings join timeout 5000 ms).
        def on_timeout():
            if not state["done"] and state["attempt"] == attempt_no:
                self._join_attempt()

        self.network.scheduler.schedule(self.settings.join_timeout_ticks, on_timeout)

        pre_join = PreJoinMessage(self.listen_address, state["node_id"])
        self.client.send_message(
            state["seed"], pre_join,
            lambda resp: self._on_phase1_response(resp, attempt_no))

    def _on_phase1_response(self, resp, attempt_no: int) -> None:
        state = self._join_state
        if state is None or state["done"] or state["attempt"] != attempt_no:
            return
        if not isinstance(resp, JoinResponse):
            return  # lost/timeout; the attempt timer retries
        if resp.status_code not in (JoinStatusCode.SAFE_TO_JOIN,
                                    JoinStatusCode.HOSTNAME_ALREADY_IN_RING):
            # Error responses that warrant a retry (Cluster.java:322-342).
            if resp.status_code == JoinStatusCode.UUID_ALREADY_IN_RING:
                state["node_id"] = self._fresh_node_id()
            self._join_attempt()
            return
        # HOSTNAME_ALREADY_IN_RING -> join with config id -1 so gatekeepers
        # stream us the configuration (Cluster.java:378-385).
        config_to_join = (
            -1 if resp.status_code == JoinStatusCode.HOSTNAME_ALREADY_IN_RING
            else resp.configuration_id
        )
        # Group ring numbers per gatekeeper (Cluster.java:416-423).
        ring_numbers_per_observer: Dict[Endpoint, List[int]] = {}
        for ring_number, observer in enumerate(resp.endpoints):
            ring_numbers_per_observer.setdefault(observer, []).append(ring_number)
        for observer, ring_numbers in ring_numbers_per_observer.items():
            msg = JoinMessage(
                sender=self.listen_address,
                node_id=state["node_id"],
                configuration_id=config_to_join,
                ring_numbers=tuple(ring_numbers),
                metadata=tuple(self.metadata.items()),
            )
            self.client.send_message(
                observer, msg,
                lambda r: self._on_phase2_response(r, config_to_join, attempt_no))

    def _on_phase2_response(self, resp, config_to_join: int, attempt_no: int) -> None:
        state = self._join_state
        if state is None or state["done"]:
            return
        if not isinstance(resp, JoinResponse):
            return
        if resp.status_code != JoinStatusCode.SAFE_TO_JOIN:
            return
        if resp.configuration_id == config_to_join:
            return
        state["done"] = True
        # Build the view from the streamed configuration (Cluster.java:446-478).
        view = MembershipView(self.settings.K, resp.identifiers, resp.endpoints)
        metadata_map = {node: dict(md) for node, md in resp.metadata}
        self._wire_service(view, metadata_map)

    def _wire_service(self, view: MembershipView,
                      metadata_map: Dict[Endpoint, Metadata]) -> None:
        cut_detector = MultiNodeCutDetector(
            self.settings.K, self.settings.H, self.settings.L)
        self.membership_service = MembershipService(
            self.listen_address, cut_detector, view, self.settings,
            self.client, self.network.scheduler, self.fd_factory,
            metadata_map, self._subscriptions, rng=self.rng,
        )
        self.server.set_membership_service(self.membership_service)
        self.server.start()

    # -- observability (Cluster.java:98-164) ---------------------------------

    def get_memberlist(self) -> List[Endpoint]:
        self._check_active()
        return self.membership_service.get_membership_view()

    def get_membership_size(self) -> int:
        self._check_active()
        return self.membership_service.get_membership_size()

    def get_configuration_id(self) -> int:
        self._check_active()
        return self.membership_service.get_configuration_id()

    def get_cluster_metadata(self) -> Dict[Endpoint, Metadata]:
        self._check_active()
        return self.membership_service.get_metadata()

    def _check_active(self) -> None:
        if self.membership_service is None:
            raise RuntimeError(f"{self.listen_address}: cluster not active")

    # -- teardown ------------------------------------------------------------

    def leave_gracefully(self) -> None:
        """Inform observers, then shut down after the leave timeout
        (Cluster.java:145-160)."""
        self._check_active()
        self.membership_service.leave()
        self.network.scheduler.schedule(
            self.settings.leave_timeout_ticks, self.shutdown)

    def shutdown(self) -> None:
        if self.membership_service is not None:
            self.membership_service.stop()
        self.server.shutdown()
