"""Pluggable SPIs of the framework (host side).

These mirror the reference's pluggable layers (SURVEY.md §1 L1/L2):

- ``IMessagingClient`` / ``IMessagingServer``  (messaging/IMessagingClient.java:26-48,
  messaging/IMessagingServer.java:24-40)
- ``IBroadcaster``                             (messaging/IBroadcaster.java:28-32)
- ``IEdgeFailureDetectorFactory``              (monitoring/IEdgeFailureDetectorFactory.java:32-34)
- ``IScheduler`` abstracts the reference's scheduled executor
  (SharedResources.java:55-56) into virtual-time ticks so every run is
  deterministic and the engines can reproduce it bit-for-bit.

Responses are modeled as callbacks rather than futures: the simulator is
single-threaded over virtual time, which is exactly the execution model the
reference enforces with its single protocol executor (SharedResources.java:54).
"""
from __future__ import annotations

import abc
from typing import Callable, List, Optional, Sequence

from rapid_tpu_torch.types import Endpoint, RapidRequest

ResponseCallback = Callable[[object], None]  # called with the response, or None on failure


class IMessagingClient(abc.ABC):
    """Send messages to a remote node. Reference: IMessagingClient.java:26-48."""

    @abc.abstractmethod
    def send_message(self, remote: Endpoint, request: RapidRequest,
                     on_response: Optional[ResponseCallback] = None) -> None:
        """Send with retransmission semantics."""

    @abc.abstractmethod
    def send_message_best_effort(self, remote: Endpoint, request: RapidRequest,
                                 on_response: Optional[ResponseCallback] = None) -> None:
        """Send without retries."""

    def shutdown(self) -> None:  # pragma: no cover - default no-op
        pass


class IMessagingServer(abc.ABC):
    """Receive messages. Reference: IMessagingServer.java:24-40."""

    @abc.abstractmethod
    def start(self) -> None: ...

    @abc.abstractmethod
    def shutdown(self) -> None: ...

    @abc.abstractmethod
    def set_membership_service(self, service) -> None:
        """Allows the server to start before the protocol is ready; probes get
        BOOTSTRAPPING responses until then (GrpcServer.java:53-96)."""


class IBroadcaster(abc.ABC):
    """Reference: IBroadcaster.java:28-32."""

    @abc.abstractmethod
    def broadcast(self, request: RapidRequest) -> None: ...

    @abc.abstractmethod
    def set_membership(self, recipients: Sequence[Endpoint]) -> None: ...


class UnicastToAllBroadcaster(IBroadcaster):
    """Default broadcaster: best-effort unicast to every member
    (UnicastToAllBroadcaster.java:36-62; recipient order shuffled per
    configuration)."""

    def __init__(self, client: IMessagingClient, rng=None) -> None:
        self._client = client
        self._rng = rng
        self._recipients: List[Endpoint] = []

    def set_membership(self, recipients: Sequence[Endpoint]) -> None:
        self._recipients = list(recipients)
        if self._rng is not None:
            self._rng.shuffle(self._recipients)

    def broadcast(self, request: RapidRequest) -> None:
        for recipient in self._recipients:
            self._client.send_message_best_effort(recipient, request)


class IScheduler(abc.ABC):
    """Virtual-time task scheduling in ticks."""

    @abc.abstractmethod
    def schedule(self, delay_ticks: int, fn: Callable[[], None]) -> object:
        """Run ``fn`` after ``delay_ticks``; returns a cancellation handle."""

    @abc.abstractmethod
    def cancel(self, handle: object) -> None: ...

    @abc.abstractmethod
    def now(self) -> int:
        """Current tick."""


class IEdgeFailureDetectorFactory(abc.ABC):
    """Per-edge failure detector SPI.

    ``create_instance(subject, notify)`` returns a zero-arg callable run once
    per failure-detector interval; implementations call ``notify()`` to mark
    the observer->subject edge faulty.
    Reference: IEdgeFailureDetectorFactory.java:32-34.
    """

    @abc.abstractmethod
    def create_instance(self, subject: Endpoint,
                        notify: Callable[[], None]) -> Callable[[], None]: ...
