"""Cluster event subscription types: own copies of the reference's
``ClusterEvents``, ``NodeStatusChange`` and ``ClusterStatusChange``."""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Tuple

from rapid_tpu_torch.types import EdgeStatus, Endpoint


class ClusterEvents(enum.Enum):
    VIEW_CHANGE_PROPOSAL = 0
    VIEW_CHANGE = 1
    VIEW_CHANGE_ONE_STEP_FAILED = 2  # declared, as in the reference; never fired
    KICKED = 3


@dataclass(frozen=True)
class NodeStatusChange:
    endpoint: Endpoint
    status: EdgeStatus
    metadata: Tuple[Tuple[str, bytes], ...] = ()


@dataclass(frozen=True)
class ClusterStatusChange:
    configuration_id: int
    membership: Tuple[Endpoint, ...]
    status_changes: Tuple[NodeStatusChange, ...]
