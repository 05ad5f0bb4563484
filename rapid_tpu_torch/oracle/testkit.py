"""Deterministic test fixtures for driving the protocol with no transport.

Mirrors the reference's strongest correctness leverage (SURVEY.md §4.2/4.5):
- ``DirectMessagingClient`` / ``DirectBroadcaster`` deliver messages by
  calling ``handle_messages`` on the target instance directly, with a
  droppable-message-type set (PaxosTests.java:424-476).
- ``ManualScheduler`` is a virtual-time scheduler driven explicitly by tests.
- ``NoOpClient`` / ``NoOpBroadcaster`` for coordinator-rule-only tests
  (PaxosTests.java:478-503).
- ``StaticFailureDetector`` marks edges faulty from a mutable blacklist
  (StaticFailureDetector.java:24-62) — deterministic failure injection via
  the public failure-detector SPI.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Set, Type

from rapid_tpu_torch.oracle.interfaces import (
    IBroadcaster,
    IEdgeFailureDetectorFactory,
    IMessagingClient,
    IScheduler,
)
from rapid_tpu_torch.types import Endpoint, RapidRequest


class ManualScheduler(IScheduler):
    """Virtual-time scheduler; tests call advance_to()/advance_by()."""

    def __init__(self) -> None:
        self._now = 0
        self._heap: List = []
        self._seq = itertools.count()
        self._cancelled: Set[int] = set()

    def now(self) -> int:
        return self._now

    def schedule(self, delay_ticks: int, fn: Callable[[], None]) -> object:
        handle = next(self._seq)
        heapq.heappush(self._heap, (self._now + delay_ticks, handle, fn))
        return handle

    def cancel(self, handle: object) -> None:
        self._cancelled.add(handle)  # type: ignore[arg-type]

    def advance_to(self, tick: int) -> None:
        while self._heap and self._heap[0][0] <= tick:
            due, handle, fn = heapq.heappop(self._heap)
            self._now = due
            if handle in self._cancelled:
                self._cancelled.discard(handle)
            else:
                fn()
        self._now = tick

    def advance_by(self, ticks: int) -> None:
        self.advance_to(self._now + ticks)


class DirectMessagingClient(IMessagingClient):
    """Synchronously delivers to registered handler objects by endpoint."""

    def __init__(self, instances: Dict[Endpoint, object],
                 drop_types: Optional[Set[Type]] = None) -> None:
        self.instances = instances
        self.drop_types = drop_types if drop_types is not None else set()

    def _deliver(self, remote: Endpoint, request: RapidRequest) -> None:
        if type(request) in self.drop_types:
            return
        target = self.instances.get(remote)
        if target is not None:
            target.handle_messages(request)

    def send_message(self, remote, request, on_response=None) -> None:
        self._deliver(remote, request)

    def send_message_best_effort(self, remote, request, on_response=None) -> None:
        self._deliver(remote, request)


class DirectBroadcaster(IBroadcaster):
    def __init__(self, instances: Dict[Endpoint, object],
                 client: DirectMessagingClient) -> None:
        self._instances = instances
        self._client = client

    def broadcast(self, request: RapidRequest) -> None:
        if type(request) in self._client.drop_types:
            return
        for endpoint in list(self._instances):
            self._client.send_message(endpoint, request)

    def set_membership(self, recipients: Sequence[Endpoint]) -> None:
        pass


class NoOpClient(IMessagingClient):
    def send_message(self, remote, request, on_response=None) -> None:
        pass

    def send_message_best_effort(self, remote, request, on_response=None) -> None:
        pass


class NoOpBroadcaster(IBroadcaster):
    def broadcast(self, request: RapidRequest) -> None:
        pass

    def set_membership(self, recipients: Sequence[Endpoint]) -> None:
        pass


class StaticFailureDetector(IEdgeFailureDetectorFactory):
    """An edge detector whose failed set is a mutable blacklist."""

    def __init__(self, failed_nodes: Optional[Set[Endpoint]] = None) -> None:
        self.failed_nodes: Set[Endpoint] = failed_nodes if failed_nodes is not None else set()

    def add_failed_nodes(self, nodes: Sequence[Endpoint]) -> None:
        self.failed_nodes.update(nodes)

    def create_instance(self, subject: Endpoint,
                        notify: Callable[[], None]) -> Callable[[], None]:
        # Re-notifies on every FD interval while blacklisted, like the
        # reference (StaticFailureDetector.java:39-44) — repeated alerts are
        # deduplicated downstream by the cut detector.
        def run() -> None:
            if subject in self.failed_nodes:
                notify()

        return run
