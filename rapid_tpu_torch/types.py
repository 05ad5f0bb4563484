"""The protocol types the host churn planner and its oracle mirror use.

Own copies of the reference's ``Endpoint``, ``NodeId``, ``EdgeStatus``,
``JoinStatusCode`` and ``AlertMessage``. ``Endpoint`` and ``NodeId`` are
NamedTuples, so they are the plain ``(hostname, port)`` and ``(high,
low)`` tuples that ``identity`` takes, with the reference's field names,
ordering and ``str``: ``str(Endpoint("n0.sim", 5000))`` is
``"n0.sim:5000"``, which the cluster rng hashes
(``oracle.cluster.default_rng``).
"""
from __future__ import annotations

import enum
from typing import NamedTuple, Tuple


class Endpoint(NamedTuple):
    """A node address, ordered by ``(hostname, port)``."""

    hostname: str
    port: int

    def __str__(self) -> str:
        return f"{self.hostname}:{self.port}"

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


class AlertMessage(NamedTuple):
    """An edge-status report from ``edge_src`` about ``edge_dst`` on each
    of ``ring_numbers``."""

    edge_src: Endpoint
    edge_dst: Endpoint
    edge_status: EdgeStatus
    configuration_id: int
    ring_numbers: Tuple[int, ...]
