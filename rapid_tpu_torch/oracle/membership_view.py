"""K-ring membership view of the host oracle and the churn planner.

Own copy of the reference oracle's ``MembershipView`` and
``Configuration`` (the snapshot a joiner is streamed): K rings, each
ordering the members by ``(hash64(uid, seed=k), uid, endpoint)``;
observers are ring successors, subjects ring predecessors, and a
joiner's expected observers (its gatekeepers) the predecessors of its
would-be position. Join safety rejects a hostname already in the ring and
a node id ever seen (identifiers are remembered forever). The
configuration id folds the identifier-fingerprint sum and the
member-fingerprint sum, as ``identity`` and the engines do.

The constructor sorts each ring once, with the ring keys hashed over
numpy arrays, where the reference inserts every endpoint into every ring
one at a time; the entries are unique, so the rings are the same.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rapid_tpu_torch import hashing
from rapid_tpu_torch.identity import SEED_MEMBER, id_fingerprint, uid_of
from rapid_tpu_torch.types import Endpoint, JoinStatusCode, NodeId

MASK64 = hashing.MASK64


def ring_key(endpoint: Endpoint, k: int) -> int:
    """Sort key of ``endpoint`` on ring ``k``."""
    return hashing.hash64(uid_of(endpoint), seed=k)


def member_fingerprint(endpoint: Endpoint) -> int:
    """Per-member contribution to the configuration id."""
    return hashing.hash64(uid_of(endpoint), seed=SEED_MEMBER)


def configuration_id(id_fp_sum: int, member_fp_sum: int) -> int:
    """The 64-bit configuration id of the two running sums."""
    return hashing.splitmix64(
        (hashing.splitmix64(id_fp_sum & MASK64) + (member_fp_sum & MASK64))
        & MASK64)


class NodeAlreadyInRingError(RuntimeError):
    pass


class NodeNotInRingError(RuntimeError):
    pass


class UUIDAlreadySeenError(RuntimeError):
    pass


class Configuration:
    """A snapshot sufficient to bootstrap an identical view: what a
    joiner receives. A view snapshotting itself passes its running
    fingerprint sums; one built from a response recomputes them."""

    def __init__(self, node_ids: Sequence[NodeId],
                 endpoints: Sequence[Endpoint],
                 id_fp_sum: Optional[int] = None,
                 member_fp_sum: Optional[int] = None):
        self.node_ids: Tuple[NodeId, ...] = tuple(node_ids)
        self.endpoints: Tuple[Endpoint, ...] = tuple(endpoints)
        self._id_fp_sum = id_fp_sum
        self._member_fp_sum = member_fp_sum

    def get_configuration_id(self) -> int:
        if self._id_fp_sum is None:
            self._id_fp_sum = sum(
                id_fingerprint(i) for i in self.node_ids) & MASK64
        if self._member_fp_sum is None:
            self._member_fp_sum = sum(
                member_fingerprint(e) for e in self.endpoints) & MASK64
        return configuration_id(self._id_fp_sum, self._member_fp_sum)


class MembershipView:
    """K rings of the membership, ordered by seeded hash."""

    def __init__(self, k: int, node_ids: Sequence[NodeId] = (),
                 endpoints: Sequence[Endpoint] = ()):
        assert k > 0
        self.K = k
        endpoints = list(endpoints)
        self._identifiers_seen: set = set()
        self._id_fp_sum = 0
        self._cached_observers: Dict[Endpoint, List[Endpoint]] = {}
        for node_id in node_ids:
            self._identifiers_seen.add(node_id)
            self._id_fp_sum = (self._id_fp_sum
                               + id_fingerprint(node_id)) & MASK64
        uids = np.array([uid_of(e) for e in endpoints], np.uint64)
        uid_list = uids.tolist()
        # ring[k] is a sorted list of (ring_key, uid, Endpoint)
        self._rings: List[List[Tuple[int, int, Endpoint]]] = [
            sorted(zip(hashing.hash64_np(uids, ring).tolist(), uid_list,
                       endpoints))
            for ring in range(k)]
        self._all_nodes: Dict[Endpoint, None] = dict.fromkeys(endpoints)
        self._member_fp_sum = sum(
            hashing.hash64_np(uids, SEED_MEMBER).tolist()) & MASK64

    # -- internal helpers ---------------------------------------------------

    def _entry(self, endpoint: Endpoint, k: int) -> Tuple[int, int, Endpoint]:
        return (ring_key(endpoint, k), uid_of(endpoint), endpoint)

    def _insert(self, endpoint: Endpoint) -> None:
        for k in range(self.K):
            bisect.insort(self._rings[k], self._entry(endpoint, k))
        self._all_nodes[endpoint] = None
        self._member_fp_sum = (self._member_fp_sum
                               + member_fingerprint(endpoint)) & MASK64

    def _remove(self, endpoint: Endpoint) -> None:
        for k in range(self.K):
            ring = self._rings[k]
            i = bisect.bisect_left(ring, self._entry(endpoint, k))
            assert i < len(ring) and ring[i][2] == endpoint
            ring.pop(i)
        del self._all_nodes[endpoint]
        self._member_fp_sum = (self._member_fp_sum
                               - member_fingerprint(endpoint)) & MASK64

    def _neighbor(self, k: int, endpoint: Endpoint,
                  direction: int) -> Optional[Endpoint]:
        """Successor (+1) or predecessor (-1) of ``endpoint``'s position on
        ring ``k`` (the endpoint itself excluded, wrapping around)."""
        ring = self._rings[k]
        if not ring:
            return None
        entry = self._entry(endpoint, k)
        if direction > 0:
            i = bisect.bisect_right(ring, entry)
            candidate = ring[i % len(ring)]
        else:
            i = bisect.bisect_left(ring, entry)
            candidate = ring[(i - 1) % len(ring)]
        if candidate[2] == endpoint:
            return None  # the only element is the endpoint itself
        return candidate[2]

    # -- queries ------------------------------------------------------------

    def is_safe_to_join(self, node: Endpoint,
                        node_id: NodeId) -> JoinStatusCode:
        if node in self._all_nodes:
            return JoinStatusCode.HOSTNAME_ALREADY_IN_RING
        if node_id in self._identifiers_seen:
            return JoinStatusCode.UUID_ALREADY_IN_RING
        return JoinStatusCode.SAFE_TO_JOIN

    def ring_add(self, node: Endpoint, node_id: NodeId) -> None:
        if node_id in self._identifiers_seen:
            raise UUIDAlreadySeenError(
                f"{node} identifier already seen: {node_id}")
        if node in self._all_nodes:
            raise NodeAlreadyInRingError(str(node))
        self._insert(node)
        self._identifiers_seen.add(node_id)
        self._id_fp_sum = (self._id_fp_sum + id_fingerprint(node_id)) & MASK64
        self._cached_observers.clear()

    def ring_delete(self, node: Endpoint) -> None:
        if node not in self._all_nodes:
            raise NodeNotInRingError(str(node))
        self._remove(node)
        self._cached_observers.clear()

    def get_observers_of(self, node: Endpoint) -> List[Endpoint]:
        """Ring successors of a member."""
        if node not in self._all_nodes:
            raise NodeNotInRingError(str(node))
        cached = self._cached_observers.get(node)
        if cached is not None:
            return list(cached)
        if len(self._all_nodes) <= 1:
            result: List[Endpoint] = []
        else:
            result = [self._neighbor(k, node, +1) for k in range(self.K)]
        self._cached_observers[node] = result
        return list(result)

    def get_subjects_of(self, node: Endpoint) -> List[Endpoint]:
        """Ring predecessors of a member."""
        if node not in self._all_nodes:
            raise NodeNotInRingError(str(node))
        if len(self._all_nodes) <= 1:
            return []
        return [self._neighbor(k, node, -1) for k in range(self.K)]

    def get_expected_observers_of(self, node: Endpoint) -> List[Endpoint]:
        """A joiner's gatekeepers: the predecessors of its would-be
        position (predecessors, as the reference has it)."""
        if not self._rings[0]:
            return []
        return [self._neighbor(k, node, -1) for k in range(self.K)]

    def get_ring_numbers(self, observer: Endpoint,
                         subject: Endpoint) -> List[int]:
        """The rings ``k`` on which ``subject`` is ``observer``'s subject."""
        subjects = self.get_subjects_of(observer)
        return [k for k, s in enumerate(subjects) if s == subject]

    def is_host_present(self, endpoint: Endpoint) -> bool:
        return endpoint in self._all_nodes

    def is_identifier_present(self, node_id: NodeId) -> bool:
        return node_id in self._identifiers_seen

    def get_ring(self, k: int) -> List[Endpoint]:
        return [e for _, _, e in self._rings[k]]

    def get_membership_size(self) -> int:
        return len(self._all_nodes)

    def get_current_configuration_id(self) -> int:
        return configuration_id(self._id_fp_sum, self._member_fp_sum)

    def get_configuration(self) -> Configuration:
        """The snapshot, with the running sums handed over."""
        return Configuration(
            sorted(self._identifiers_seen, key=lambda i: (i.high, i.low)),
            self.get_ring(0),
            id_fp_sum=self._id_fp_sum,
            member_fp_sum=self._member_fp_sum,
        )

    def ring0_sort_key(self, endpoint: Endpoint):
        """Ring-0 hash order, the consistent order of endpoint lists."""
        return (ring_key(endpoint, 0), uid_of(endpoint))
