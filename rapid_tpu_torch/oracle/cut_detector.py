"""Multi-node cut detector, the host mirror the churn planner replays.

Own copy of the reference oracle's ``MultiNodeCutDetector``, with its
results and emission order:

- reports are deduplicated per destination and ring number;
- a destination reaching L distinct-ring reports is in flux (the
  pre-proposal set, counted by ``updates_in_progress``); reaching H moves
  it to the pending proposal;
- the pending proposal is emitted when a destination reaches H while no
  destination is in flux; reports are not cleared on emission;
- ``invalidate_failing_edges``: for every destination in flux, in
  insertion order, each ring whose observer is itself in the proposal or
  pre-proposal reports implicitly (DOWN for a member, UP for a joiner).
"""
from __future__ import annotations

from typing import Dict, List

from rapid_tpu_torch.types import AlertMessage, EdgeStatus, Endpoint

_K_MIN = 3


class MultiNodeCutDetector:
    def __init__(self, k: int, h: int, l: int) -> None:  # noqa: E741
        if h > k or l > h or k < _K_MIN or l <= 0 or h <= 0:
            raise ValueError(
                f"Arguments do not satisfy K > H >= L >= 0: (K: {k}, H: {h}, "
                f"L: {l})")
        self.K = k
        self.H = h
        self.L = l
        self._proposal_count = 0
        self._updates_in_progress = 0
        # dst -> {ring_number -> reporter}
        self._reports_per_host: Dict[Endpoint, Dict[int, Endpoint]] = {}
        self._proposal: Dict[Endpoint, None] = {}      # insertion-ordered
        self._pre_proposal: Dict[Endpoint, None] = {}  # insertion-ordered
        self._seen_link_down_events = False

    def get_num_proposals(self) -> int:
        return self._proposal_count

    def aggregate_for_proposal(self, msg: AlertMessage) -> List[Endpoint]:
        result: List[Endpoint] = []
        for ring_number in msg.ring_numbers:
            result.extend(self._aggregate(msg.edge_src, msg.edge_dst,
                                          msg.edge_status, ring_number))
        return result

    def _aggregate(self, link_src: Endpoint, link_dst: Endpoint,
                   edge_status: EdgeStatus,
                   ring_number: int) -> List[Endpoint]:
        assert ring_number <= self.K
        if edge_status == EdgeStatus.DOWN:
            self._seen_link_down_events = True

        reports_for_host = self._reports_per_host.setdefault(link_dst, {})
        if ring_number in reports_for_host:
            return []  # a duplicate announcement
        reports_for_host[ring_number] = link_src
        num_reports = len(reports_for_host)

        if num_reports == self.L:
            self._updates_in_progress += 1
            self._pre_proposal[link_dst] = None

        if num_reports == self.H:
            self._pre_proposal.pop(link_dst, None)
            self._proposal[link_dst] = None
            self._updates_in_progress -= 1
            if self._updates_in_progress == 0:
                self._proposal_count += 1
                ret = list(self._proposal)
                self._proposal.clear()
                return ret

        return []

    def invalidate_failing_edges(self, view) -> List[Endpoint]:
        """Implicit reports for the destinations in flux; ``view`` is an
        ``oracle.membership_view.MembershipView``."""
        if not self._seen_link_down_events:
            return []

        proposals_to_return: List[Endpoint] = []
        for node_in_flux in list(self._pre_proposal):
            is_present = view.is_host_present(node_in_flux)
            observers = (view.get_observers_of(node_in_flux) if is_present
                         else view.get_expected_observers_of(node_in_flux))
            for ring_number, observer in enumerate(observers):
                if observer in self._proposal or \
                        observer in self._pre_proposal:
                    status = EdgeStatus.DOWN if is_present else EdgeStatus.UP
                    proposals_to_return.extend(self._aggregate(
                        observer, node_in_flux, status, ring_number))
        return proposals_to_return

    def clear(self) -> None:
        self._reports_per_host.clear()
        self._proposal.clear()
        self._updates_in_progress = 0
        self._proposal_count = 0
        self._pre_proposal.clear()
        self._seen_link_down_events = False
