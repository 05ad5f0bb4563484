"""The host oracle of the Rapid protocol: the referee of both engines.

Own copies of the reference oracle, a tick-driven, deterministic
reimplementation of the protocol core: ``MembershipView``, the multi-node
cut detector, ``FastPaxos`` with classic ``Paxos``, the
``MembershipService`` state machine, and a deterministic in-process
network and clock (``simulation``) under the ``Cluster`` facade
(``cluster``). It is plain Python and needs no device. It is the ground
truth of ``engine.diff``'s differentials, and the churn planner
(``engine.churn.plan_churn``) replays its view and cut detector.
"""

from rapid_tpu_torch.oracle.membership_view import (
    MembershipView,
    Configuration,
    NodeAlreadyInRingError,
    NodeNotInRingError,
    UUIDAlreadySeenError,
)
from rapid_tpu_torch.oracle.cut_detector import MultiNodeCutDetector
from rapid_tpu_torch.oracle.paxos import Paxos, FastPaxos
from rapid_tpu_torch.oracle.metadata import MetadataManager

__all__ = [
    "MembershipView",
    "Configuration",
    "MultiNodeCutDetector",
    "Paxos",
    "FastPaxos",
    "MetadataManager",
    "NodeAlreadyInRingError",
    "NodeNotInRingError",
    "UUIDAlreadySeenError",
]
