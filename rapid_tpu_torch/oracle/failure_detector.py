"""Default edge failure detector: probe-based ping-pong.

Mirrors PingPongFailureDetector.java:39-142:
- each FD interval, probe the subject (best-effort);
- failed/lost probes increment a failure count; at >= failure_threshold
  (reference: 10) the edge is reported DOWN exactly once;
- a BOOTSTRAPPING response (node in the view whose protocol has not started
  yet) is tolerated up to bootstrap_tolerance times (reference: 30) before
  counting as failures.

Probes use the network's synchronous fast path (see SimNetwork.probe); the
reference's probe deadline equals one FD interval so the timing is
equivalent, and the engines evaluate probes the same way.
"""
from __future__ import annotations

from typing import Callable

from rapid_tpu_torch.oracle.interfaces import IEdgeFailureDetectorFactory
from rapid_tpu_torch.types import Endpoint, ProbeStatus


class PingPongFailureDetector:
    def __init__(self, network, address: Endpoint, subject: Endpoint,
                 notify: Callable[[], None],
                 failure_threshold: int = 10,
                 bootstrap_tolerance: int = 30) -> None:
        self._network = network
        self._address = address
        self._subject = subject
        self._notify = notify
        self._failure_threshold = failure_threshold
        self._bootstrap_tolerance = bootstrap_tolerance
        self._failure_count = 0
        self._bootstrap_responses = 0
        self._notified = False

    def __call__(self) -> None:
        if self._failure_count >= self._failure_threshold:
            if not self._notified:
                self._notified = True
                self._notify()
            return
        response = self._network.probe(self._address, self._subject)
        if response is None:
            self._failure_count += 1
        elif response.status == ProbeStatus.BOOTSTRAPPING:
            self._bootstrap_responses += 1
            if self._bootstrap_responses > self._bootstrap_tolerance:
                self._failure_count += 1


class PingPongFailureDetectorFactory(IEdgeFailureDetectorFactory):
    def __init__(self, network, address: Endpoint,
                 failure_threshold: int = 10,
                 bootstrap_tolerance: int = 30) -> None:
        self._network = network
        self._address = address
        self._failure_threshold = failure_threshold
        self._bootstrap_tolerance = bootstrap_tolerance

    def create_instance(self, subject: Endpoint,
                        notify: Callable[[], None]) -> Callable[[], None]:
        return PingPongFailureDetector(
            self._network, self._address, subject, notify,
            self._failure_threshold, self._bootstrap_tolerance,
        )
