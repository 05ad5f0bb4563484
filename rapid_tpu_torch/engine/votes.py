"""Fast Paxos fast-round vote counting of the shared engine.

A receiver decides when it has seen at least the fast quorum
``N - floor((N-1)/4)`` of votes and one proposal value holds that many.
Votes are tallied as a segmented count over 64-bit proposal fingerprints:
sort the ``(hi, lo)`` vote hashes, mark run starts, and sum the valid
votes of each run; no ``[C, C]`` comparison matrix is built.
"""
from __future__ import annotations

import torch

from rapid_tpu_torch import hashing

PROPOSAL_SEED = 0x70726F70


def proposal_fingerprint(proposal_mask, uid_hi, uid_lo):
    """64-bit fingerprint of a proposal mask, as 0-d ``(hi, lo)`` limbs:
    the order-independent sum of per-member hashes, finalised with
    splitmix64."""
    phi, plo = hashing.hash64_limbs(uid_hi, uid_lo, seed=PROPOSAL_SEED)
    m = proposal_mask.reshape(-1).to(torch.int64)
    shi, slo = hashing.sum64_axis(phi.reshape(-1) * m, plo.reshape(-1) * m)
    return hashing.splitmix64_limbs(shi, slo)


def segmented_vote_count(vote_hi, vote_lo, valid):
    """i32 [C]: for each slot, the number of valid votes equal to its
    vote; invalid slots count 0.

    The reference's ``lexsort((lo, hi, invalid))`` is three stable sorts,
    least significant key first. Runs are split on ``(hi, lo)`` alone, so
    an invalid vote may share a run with valid ones: it adds nothing to
    the run's sum and reads 0 itself. The run sums are int32
    ``index_add_``, exact in any order of accumulation.
    """
    c = vote_hi.shape[0]
    dev = vote_hi.device
    order = torch.argsort(vote_lo, stable=True)
    order = order[torch.argsort(vote_hi[order], stable=True)]
    order = order[torch.argsort((~valid[order]).to(torch.uint8),
                                stable=True)]
    shi = vote_hi[order]
    slo = vote_lo[order]
    sval = valid[order].to(torch.int32)
    starts = torch.ones(c, dtype=torch.bool, device=dev)
    starts[1:] = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
    seg_id = torch.cumsum(starts, dim=0) - 1
    seg_counts = torch.zeros(c, dtype=torch.int32, device=dev).index_add_(
        0, seg_id, sval)
    out = torch.zeros(c, dtype=torch.int32, device=dev)
    out[order] = seg_counts[seg_id] * sval
    return out


def fast_quorum(n_member):
    """i32: the fast quorum ``N - floor((N-1)/4)`` as the reference has
    it (floor division, so N = 0 gives 1; not ``ceil(3N/4)``)."""
    n = torch.as_tensor(n_member)
    return (n - torch.div(n - 1, 4, rounding_mode="floor")).to(torch.int32)


def count_fast_round(vote_hi, vote_lo, valid, n_member):
    """``(decided, winner_count)``: both the delivered votes and one
    value's votes reach the fast quorum."""
    quorum = fast_quorum(n_member)
    winner = segmented_vote_count(vote_hi, vote_lo, valid).max()
    total = valid.sum().to(torch.int32)
    return (total >= quorum) & (winner >= quorum), winner
