"""Per-node metadata tags.

Reference: MetadataManager.java:31-70 — immutable per-node key->bytes maps,
add-if-absent semantics, removed when a node leaves, full map shared with
joiners.
"""
from __future__ import annotations

from typing import Dict, Mapping

from rapid_tpu_torch.types import Endpoint, Metadata


class MetadataManager:
    def __init__(self) -> None:
        self._table: Dict[Endpoint, Metadata] = {}

    def get(self, node: Endpoint) -> Metadata:
        return dict(self._table.get(node, {}))

    def add_metadata(self, roles: Mapping[Endpoint, Metadata]) -> None:
        """Add-if-absent, per the reference (MetadataManager.java:46-52)."""
        for node, metadata in roles.items():
            self._table.setdefault(node, dict(metadata))

    def remove_node(self, node: Endpoint) -> None:
        self._table.pop(node, None)

    def get_all_metadata(self) -> Dict[Endpoint, Metadata]:
        return {node: dict(md) for node, md in self._table.items()}
