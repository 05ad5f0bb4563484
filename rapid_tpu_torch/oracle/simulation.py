"""Deterministic tick-driven simulation substrate (virtual network + clock).

This is the oracle counterpart of the reference's runtime substrate
(SharedResources.java thread pools + gRPC transport, SURVEY.md §2.4/2.5),
collapsed into one single-threaded discrete-event engine over virtual time:

- One tick = one alert-batching window (Settings.tick_ms, default 100 ms).
- A message sent in tick t is delivered in tick t+1, subject to the fault
  model evaluated at delivery time; replies travel the same way.
- Requests that expect a reply get a timeout: if no reply arrives within
  ``rpc_timeout_ticks`` the response callback fires with None (the analog of
  the reference's per-message-type gRPC deadlines, GrpcClient.java:194-203).
- Probes take a synchronous fast path (``probe()``): the reference's probe
  timeout equals one FD interval, so evaluating reachability at probe time
  is equivalent and is exactly what the engines do.

Everything in a tick runs in a canonical deterministic order:
(1) message deliveries in send order, (2) scheduled tasks in schedule order.
The kernel engine reproduces this order bit-for-bit (SURVEY.md §7 "hard
parts": canonical intra-round alert order).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from rapid_tpu_torch.faults import HEALTHY, FaultModel
from rapid_tpu_torch.oracle.interfaces import IMessagingClient, IScheduler
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import (
    Endpoint,
    FastRoundPhase2bMessage,
    JoinMessage,
    Phase1aMessage,
    Phase1bMessage,
    Phase2aMessage,
    Phase2bMessage,
    PreJoinMessage,
    ProbeMessage,
    ProbeResponse,
    ProbeStatus,
    RapidRequest,
)

ReplyFn = Callable[[object], None]
# A server handler receives (request, reply) and may call reply now or later.
ServerHandler = Callable[[RapidRequest, ReplyFn], None]

# Consensus message classes tracked per phase for the fallback differential
# (``engine.diff.run_fallback_differential``). Kept separate from
# NetworkCounters so the existing total-parity checks are untouched.
CONSENSUS_PHASES = ("fast_vote", "phase1a", "phase1b", "phase2a", "phase2b")


_PHASE_OF_TYPE = {
    FastRoundPhase2bMessage: "fast_vote",
    Phase1aMessage: "phase1a",
    Phase1bMessage: "phase1b",
    Phase2aMessage: "phase2a",
    Phase2bMessage: "phase2b",
}


def consensus_phase_of(request: RapidRequest) -> Optional[str]:
    """Phase key for a consensus message, None for everything else (the
    message classes are final, so the exact type decides)."""
    return _PHASE_OF_TYPE.get(type(request))


def empty_consensus_counters() -> Dict[str, int]:
    return {f"{p}_{kind}": 0
            for p in CONSENSUS_PHASES for kind in ("sent", "delivered")}


@dataclass
class NetworkCounters:
    """Message accounting, used by the engine differential for per-tick
    message-count parity (``engine.diff``).

    ``sent`` counts ``send()`` calls (probes take the synchronous fast path
    and are tallied separately); ``delivered``/``dropped`` partition the
    messages that came due; ``timeouts`` counts response callbacks fired
    with None.
    """

    sent: int = 0
    delivered: int = 0
    dropped: int = 0
    timeouts: int = 0
    probes_sent: int = 0
    probes_failed: int = 0

    def snapshot(self) -> "NetworkCounters":
        return NetworkCounters(**self.as_dict())

    def delta(self, since: "NetworkCounters") -> "NetworkCounters":
        return NetworkCounters(**{k: v - getattr(since, k)
                                  for k, v in self.as_dict().items()})

    def as_dict(self) -> Dict[str, int]:
        return {
            "sent": self.sent,
            "delivered": self.delivered,
            "dropped": self.dropped,
            "timeouts": self.timeouts,
            "probes_sent": self.probes_sent,
            "probes_failed": self.probes_failed,
        }


class SimScheduler(IScheduler):
    """Deterministic virtual-time scheduler shared by all simulated nodes."""

    def __init__(self) -> None:
        self._now = 0
        self._heap: List[Tuple[int, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self._cancelled: set[int] = set()

    def now(self) -> int:
        return self._now

    def schedule(self, delay_ticks: int, fn: Callable[[], None]) -> object:
        handle = next(self._seq)
        heapq.heappush(self._heap, (self._now + max(0, delay_ticks), handle, fn))
        return handle

    def cancel(self, handle: object) -> None:
        self._cancelled.add(handle)  # type: ignore[arg-type]

    def _run_due(self, tick: int) -> None:
        while self._heap and self._heap[0][0] <= tick:
            _, handle, fn = heapq.heappop(self._heap)
            if handle in self._cancelled:
                self._cancelled.discard(handle)
            else:
                fn()

    def _advance(self, tick: int) -> None:
        self._now = tick


class SimNetwork:
    """The virtual network: registered node servers + in-flight messages."""

    def __init__(self, settings: Settings, fault_model: FaultModel = HEALTHY) -> None:
        self.settings = settings
        self.fault_model = fault_model
        self.scheduler = SimScheduler()
        self._seq = itertools.count()
        # deliver_tick -> [(seq, src, dst, request, reply_to_src or None)]
        self._in_flight: Dict[int, List] = {}
        self._servers: Dict[Endpoint, "SimServer"] = {}
        self.rpc_timeout_ticks = 2
        self.counters = NetworkCounters()       # cumulative
        self.last_tick_counters = NetworkCounters()  # delta of the last step()
        # Per-tick counter deltas, one dict per step() in order — the
        # oracle half of the telemetry layer's unified TickMetrics stream
        # (``telemetry.metrics.oracle_metrics``).
        self.tick_history: List[Dict[str, int]] = []
        # Per-phase consensus message accounting (cumulative + per-tick),
        # network-level: a message to a kicked-but-registered node still
        # counts as delivered, exactly like NetworkCounters.delivered.
        self.consensus_counters: Dict[str, int] = empty_consensus_counters()
        self.consensus_history: List[Dict[str, int]] = []

    @property
    def tick(self) -> int:
        return self.scheduler.now()

    @property
    def message_counter(self) -> int:
        """Total messages sent (back-compat alias for ``counters.sent``)."""
        return self.counters.sent

    # -- registration --------------------------------------------------------

    def register(self, server: "SimServer") -> None:
        self._servers[server.address] = server

    def deregister(self, address: Endpoint) -> None:
        self._servers.pop(address, None)

    def server_of(self, address: Endpoint) -> Optional["SimServer"]:
        return self._servers.get(address)

    # -- sending -------------------------------------------------------------

    def send(self, src: Endpoint, dst: Endpoint, request: RapidRequest,
             on_response: Optional[ReplyFn] = None,
             timeout_ticks: Optional[int] = None) -> None:
        """Queue a message for delivery next tick (plus any link delay).

        Delay rules are evaluated at *send* time — the latency of a link is
        a property of the wire the message entered — while crashes, link
        windows, and drops are evaluated at *delivery* time, exactly like
        both engine referees. Jittered delays can reorder consecutive
        messages on one edge; delivery within a tick stays in send order.
        """
        self.counters.sent += 1
        phase = consensus_phase_of(request)
        if phase is not None:
            self.consensus_counters[f"{phase}_sent"] += 1
        delay = self.fault_model.delay_of(src, dst, self.tick)
        deliver_at = self.tick + 1 + delay
        self._in_flight.setdefault(deliver_at, []).append(
            (next(self._seq), src, dst, request, on_response)
        )
        if on_response is not None:
            # Arm the timeout; a delivered reply cancels it by marking done.
            state = {"done": False}
            entry = self._in_flight[deliver_at][-1]
            if timeout_ticks is None:
                timeout_ticks = self.rpc_timeout_ticks
            def timeout(state=state, cb=on_response):
                if not state["done"]:
                    state["done"] = True
                    self.counters.timeouts += 1
                    cb(None)
            # The deadline clock starts when the message hits the far end
            # of the wire: a slow link stretches the round-trip budget the
            # same way on both referees (the engines arm their reply
            # timers at delivery too).
            handle = self.scheduler.schedule(timeout_ticks + 1 + delay, timeout)
            # Replace the callback with a once-only wrapper that defuses the timeout.
            def once(resp, state=state, cb=on_response, handle=handle):
                if not state["done"]:
                    state["done"] = True
                    self.scheduler.cancel(handle)
                    cb(resp)
            self._in_flight[deliver_at][-1] = (entry[0], src, dst, request, once)

    def probe(self, observer: Endpoint, subject: Endpoint) -> Optional[ProbeResponse]:
        """Synchronous probe fast-path; None = probe failed (timeout/loss).

        Fault semantics are connection-oriented (like the reference's gRPC):
        ``edge_ok(src, dst)`` gates requests *initiated* by src toward dst;
        the response rides back on the initiator's connection and is not
        separately masked. This is what makes a one-way (ingress) partition
        remove exactly the partitioned node (ATC'18 §5 Fig. 9): the target
        can still probe its own subjects, while its observers cannot reach
        it."""
        t = self.tick
        fm = self.fault_model
        self.counters.probes_sent += 1
        if fm.is_crashed(subject, t) or fm.is_crashed(observer, t):
            self.counters.probes_failed += 1
            return None
        if not fm.edge_ok(observer, subject, t):
            self.counters.probes_failed += 1
            return None
        server = self._servers.get(subject)
        if server is None:
            self.counters.probes_failed += 1
            return None
        if server.service is None:
            # Server up, protocol not ready (GrpcServer.java:83-95)
            return ProbeResponse(ProbeStatus.BOOTSTRAPPING)
        return ProbeResponse(ProbeStatus.OK)

    # -- the tick loop -------------------------------------------------------

    def at(self, tick: int, fn: Callable[[], None]) -> object:
        """Schedule a host action (e.g. ``cluster.join``) at an absolute
        tick. The handle is allocated now, so actions scheduled before the
        simulation starts sort ahead of every message-processing task due
        the same tick — host operations lead the tick, deterministically."""
        assert tick >= self.tick, f"tick {tick} already passed ({self.tick})"
        return self.scheduler.schedule(tick - self.tick, fn)

    def step(self) -> None:
        """Advance one tick: deliver due messages, then run due tasks."""
        before = self.counters.snapshot()
        consensus_before = dict(self.consensus_counters)
        t = self.tick + 1
        self.scheduler._advance(t)
        for seq, src, dst, request, reply in sorted(self._in_flight.pop(t, [])):
            fm = self.fault_model
            if fm.is_crashed(src, t):
                self.counters.dropped += 1
                continue  # sender died before the message got out
            if fm.is_crashed(dst, t) or not fm.edge_ok(src, dst, t):
                self.counters.dropped += 1
                continue  # lost; any reply timeout fires later
            server = self._servers.get(dst)
            if server is None:
                self.counters.dropped += 1
                continue
            self.counters.delivered += 1
            phase = consensus_phase_of(request)
            if phase is not None:
                self.consensus_counters[f"{phase}_delivered"] += 1
            if reply is not None:
                # Route the reply back through the network (subject to faults).
                def reply_via_net(resp, src=src, dst=dst, reply=reply):
                    self._deliver_reply(dst, src, resp, reply)
                server.handle(request, reply_via_net)
            else:
                server.handle(request, lambda resp: None)
        self.scheduler._run_due(t)
        self.last_tick_counters = self.counters.delta(before)
        self.tick_history.append(self.last_tick_counters.as_dict())
        self.consensus_history.append(
            {k: v - consensus_before[k]
             for k, v in self.consensus_counters.items()})

    def _deliver_reply(self, src: Endpoint, dst: Endpoint, resp: object,
                       reply: ReplyFn) -> None:
        """Schedule a reply from src (the server) back to dst (the caller)."""
        deliver_at = self.tick + 1

        def do_deliver():
            # Replies ride the requester's established connection: only
            # crashes can lose them, not directional edge masks (see probe()).
            fm = self.fault_model
            if fm.is_crashed(src, self.tick) or fm.is_crashed(dst, self.tick):
                return  # lost; caller's timeout will fire
            reply(resp)

        self.scheduler.schedule(deliver_at - self.tick, do_deliver)

    def run_ticks(self, n: int) -> None:
        for _ in range(n):
            self.step()


class SimServer:
    """A node's server endpoint in the virtual network.

    Mirrors IMessagingServer semantics: it can be registered before the
    protocol is ready (``service is None`` -> probes answer BOOTSTRAPPING,
    everything else is dropped; GrpcServer.java:53-96)."""

    def __init__(self, network: SimNetwork, address: Endpoint) -> None:
        self.network = network
        self.address = address
        self.service = None  # set via set_membership_service

    def start(self) -> None:
        self.network.register(self)

    def shutdown(self) -> None:
        self.network.deregister(self.address)

    def set_membership_service(self, service) -> None:
        self.service = service

    def handle(self, request: RapidRequest, reply: ReplyFn) -> None:
        if self.service is None:
            if isinstance(request, ProbeMessage):
                reply(ProbeResponse(ProbeStatus.BOOTSTRAPPING))
            return  # drop everything else until the service is wired
        self.service.handle_message(request, reply)


class SimMessagingClient(IMessagingClient):
    """IMessagingClient over the virtual network (one per node).

    Join-protocol requests get the long deadline, everything else the default
    — mirroring the reference's per-message-type gRPC deadlines of 5 s for
    joins vs 1 s default (GrpcClient.java:194-203): a phase-2 join reply is
    parked at the gatekeeper until consensus completes, so it must outlive
    the batching + consensus pipeline."""

    def __init__(self, network: SimNetwork, address: Endpoint) -> None:
        self._network = network
        self.address = address

    def _timeout_for(self, request: RapidRequest) -> int:
        if isinstance(request, (JoinMessage, PreJoinMessage)):
            return self._network.settings.join_timeout_ticks
        return self._network.rpc_timeout_ticks

    def send_message(self, remote: Endpoint, request: RapidRequest,
                     on_response: Optional[ReplyFn] = None) -> None:
        self._network.send(self.address, remote, request, on_response,
                           timeout_ticks=self._timeout_for(request))

    def send_message_best_effort(self, remote: Endpoint, request: RapidRequest,
                                 on_response: Optional[ReplyFn] = None) -> None:
        self._network.send(self.address, remote, request, on_response,
                           timeout_ticks=self._timeout_for(request))
