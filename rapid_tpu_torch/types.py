"""The protocol types: addresses, identifiers and the protocol messages.

Own copies of the reference's types. ``Endpoint`` and ``NodeId`` are
NamedTuples, so they are the plain ``(hostname, port)`` and ``(high,
low)`` tuples that ``identity`` takes, with the reference's field names,
ordering, hash and ``str``: ``str(Endpoint("n0.sim", 5000))`` is
``"n0.sim:5000"``, which the cluster rng hashes
(``oracle.cluster.default_rng``). A frozen dataclass hashes as the tuple
of its fields, so sets and dicts of either form iterate alike.

``AlertMessage`` is a NamedTuple too (the churn planner builds it); the
other messages are frozen dataclasses, as the reference's are: a
dataclass equals only its own class, so two messages of different kinds
with equal fields never merge in a set or a dict. ``Rank`` alone orders.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple


class Endpoint(NamedTuple):
    """A node address, ordered by ``(hostname, port)``."""

    hostname: str
    port: int

    def __str__(self) -> str:
        return f"{self.hostname}:{self.port}"

    @staticmethod
    def parse(s: str) -> "Endpoint":
        host, _, port = s.rpartition(":")
        if not host or not port:
            raise ValueError(f"malformed endpoint: {s!r}")
        return Endpoint(host, int(port))

    @staticmethod
    def of(endpoint) -> "Endpoint":
        """An ``Endpoint`` from anything with ``hostname`` and ``port``
        attributes, or a ``(hostname, port)`` pair."""
        if hasattr(endpoint, "hostname"):
            return Endpoint(endpoint.hostname, endpoint.port)
        return Endpoint(*endpoint)


class NodeId(NamedTuple):
    """A 128-bit logical node identifier, ordered by ``(high, low)``."""

    high: int
    low: int

    @staticmethod
    def of(node_id) -> "NodeId":
        """A ``NodeId`` from anything with ``high`` and ``low`` attributes,
        or a ``(high, low)`` pair."""
        if hasattr(node_id, "high"):
            return NodeId(node_id.high, node_id.low)
        return NodeId(*node_id)


class EdgeStatus(enum.Enum):
    UP = 0
    DOWN = 1


class JoinStatusCode(enum.Enum):
    HOSTNAME_ALREADY_IN_RING = 0
    UUID_ALREADY_IN_RING = 1
    SAFE_TO_JOIN = 2
    CONFIG_CHANGED = 3
    MEMBERSHIP_REJECTED = 4


Metadata = Dict[str, bytes]


class AlertMessage(NamedTuple):
    """An edge-status report from ``edge_src`` about ``edge_dst`` on each
    of ``ring_numbers``; ``node_id`` and ``metadata`` ride along only on
    UP (join) alerts."""

    edge_src: Endpoint
    edge_dst: Endpoint
    edge_status: EdgeStatus
    configuration_id: int
    ring_numbers: Tuple[int, ...]
    node_id: Optional[NodeId] = None
    metadata: Tuple[Tuple[str, bytes], ...] = ()


# ---------------------------------------------------------------------------
# Protocol messages
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PreJoinMessage:
    """Join phase 1, joiner -> seed."""

    sender: Endpoint
    node_id: NodeId


@dataclass(frozen=True)
class JoinMessage:
    """Join phase 2, joiner -> gatekeeper."""

    sender: Endpoint
    node_id: NodeId
    configuration_id: int
    ring_numbers: Tuple[int, ...]
    metadata: Tuple[Tuple[str, bytes], ...] = ()


@dataclass(frozen=True)
class JoinResponse:
    sender: Endpoint
    status_code: JoinStatusCode
    configuration_id: int
    endpoints: Tuple[Endpoint, ...] = ()
    identifiers: Tuple[NodeId, ...] = ()
    metadata: Tuple[Tuple[Endpoint, Tuple[Tuple[str, bytes], ...]], ...] = ()


@dataclass(frozen=True)
class BatchedAlertMessage:
    sender: Endpoint
    messages: Tuple[AlertMessage, ...]


@dataclass(frozen=True)
class FastRoundPhase2bMessage:
    """A fast-round vote."""

    sender: Endpoint
    configuration_id: int
    endpoints: Tuple[Endpoint, ...]


@dataclass(frozen=True, order=True)
class Rank:
    """Classic-round rank, ordered by ``(round, node_index)``."""

    round: int
    node_index: int


@dataclass(frozen=True)
class Phase1aMessage:
    sender: Endpoint
    configuration_id: int
    rank: Rank


@dataclass(frozen=True)
class Phase1bMessage:
    sender: Endpoint
    configuration_id: int
    rnd: Rank
    vrnd: Rank
    vval: Tuple[Endpoint, ...]


@dataclass(frozen=True)
class Phase2aMessage:
    sender: Endpoint
    configuration_id: int
    rnd: Rank
    vval: Tuple[Endpoint, ...]


@dataclass(frozen=True)
class Phase2bMessage:
    sender: Endpoint
    configuration_id: int
    rnd: Rank
    endpoints: Tuple[Endpoint, ...]


@dataclass(frozen=True)
class LeaveMessage:
    sender: Endpoint


@dataclass(frozen=True)
class ProbeMessage:
    sender: Endpoint


class ProbeStatus(enum.Enum):
    OK = 0
    BOOTSTRAPPING = 1


@dataclass(frozen=True)
class ProbeResponse:
    status: ProbeStatus = ProbeStatus.OK


@dataclass(frozen=True)
class Response:
    """The empty response."""


RapidRequest = (
    PreJoinMessage
    | JoinMessage
    | BatchedAlertMessage
    | FastRoundPhase2bMessage
    | Phase1aMessage
    | Phase1bMessage
    | Phase2aMessage
    | Phase2bMessage
    | LeaveMessage
    | ProbeMessage
)

CONSENSUS_MESSAGE_TYPES = (
    FastRoundPhase2bMessage,
    Phase1aMessage,
    Phase1bMessage,
    Phase2aMessage,
    Phase2bMessage,
)
