"""Ring dissemination: alerts and votes travel the static ring-0 order.

A broadcast-shaped exchange costs one aggregation lap and one
dissemination lap, a sender factor of 2 instead of S. The ring changes
only transport: the reference enters votes and reports in ring-0 order
and reads them back at each slot's ring-0 rank, a permutation round
trip, so the shared engine tallies and delivers with ``votes`` and
``cut`` as "rapid" does and takes only the factor from here.
"""
from __future__ import annotations

import torch


def ring_pair_factor(any_mask):
    """i32: the ring's sender factor for one exchange, 2 when any slot of
    ``any_mask`` sends (one lap up, one down), else 0; a ``[F, C]`` mask
    gives one factor per fleet member."""
    return torch.where(any_mask.any(dim=-1), 2, 0).to(torch.int32)
