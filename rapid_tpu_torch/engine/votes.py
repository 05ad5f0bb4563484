"""Fast Paxos fast-round vote counting of the shared engine.

A receiver decides when it has seen at least the fast quorum
``N - floor((N-1)/4)`` of votes and one proposal value holds that many.
Votes are tallied as a segmented count over 64-bit proposal fingerprints:
sort the ``(hi, lo)`` vote hashes, mark run starts, and sum the valid
votes of each run; no ``[C, C]`` comparison matrix is built.
``scan_vote_count`` gives the same tally through scans, as the ring
variant's aggregation kernel does (``telemetry.profile``'s variant block).

On a slot mesh (``group``) the sorts and scans run on the all-gathered
votes, replicated, and each shard keeps its slots of the tally; the
fingerprint's limb sums and the fast round's counts are all-reduced.
"""
from __future__ import annotations

import torch

from rapid_tpu_torch import hashing
from rapid_tpu_torch.engine.sharding import SOLO

PROPOSAL_SEED = 0x70726F70


def proposal_fingerprint(proposal_mask, uid_hi, uid_lo, group=SOLO):
    """64-bit fingerprint of a proposal mask, as 0-d ``(hi, lo)`` limbs:
    the order-independent sum of per-member hashes, finalised with
    splitmix64; on a slot mesh each shard's partial sum is added with
    ``group.sum64``."""
    phi, plo = hashing.hash64_limbs(uid_hi, uid_lo, seed=PROPOSAL_SEED)
    m = proposal_mask.reshape(-1).to(torch.int64)
    shi, slo = hashing.sum64_axis(phi.reshape(-1) * m, plo.reshape(-1) * m)
    shi, slo = group.sum64(shi, slo)
    return hashing.splitmix64_limbs(shi, slo)


def segmented_vote_count(vote_hi, vote_lo, valid, group=SOLO):
    """i32 [C]: for each slot, the number of valid votes equal to its
    vote; invalid slots count 0.

    The reference's ``lexsort((lo, hi, invalid))`` is three stable sorts,
    least significant key first. Runs are split on ``(hi, lo)`` alone, so
    an invalid vote may share a run with valid ones: it adds nothing to
    the run's sum and reads 0 itself. The run sums are an int32
    ``scatter_add``, exact in any order of accumulation. Every write is
    out of place and batches natively, so a fleet maps the function over
    its members (``torch.func.vmap``) in one op per step whatever their
    number. On a slot mesh the count runs on the all-gathered votes and
    the shard's slots of it are returned.
    """
    if group.size > 1:
        return group.local(segmented_vote_count(
            *group.all_gather(vote_hi, vote_lo, valid, dim=-1)), dim=-1)
    c = vote_hi.shape[-1]
    dev = vote_hi.device
    order, sval, starts = _sorted_runs(vote_hi, vote_lo, valid)
    seg_id = torch.cumsum(starts, dim=0) - 1
    seg_counts = torch.zeros(c, dtype=torch.int32, device=dev).scatter_add(
        0, seg_id, sval)
    return torch.zeros(c, dtype=torch.int32, device=dev).scatter(
        0, order, seg_counts[seg_id] * sval)


def _sorted_runs(vote_hi, vote_lo, valid):
    """``(order, sval, starts)``: the reference's ``lexsort((lo, hi,
    invalid))`` as three stable sorts, least significant key first; the
    valid mask in that order as int32; and where a run of equal
    ``(hi, lo)`` starts."""
    order = torch.argsort(vote_lo, stable=True)
    order = order[torch.argsort(vote_hi[order], stable=True)]
    order = order[torch.argsort((~valid[order]).to(torch.uint8),
                                stable=True)]
    shi = vote_hi[order]
    slo = vote_lo[order]
    first = torch.ones(1, dtype=torch.bool, device=vote_hi.device)
    starts = torch.cat([first, (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])])
    return order, valid[order].to(torch.int32), starts


def scan_vote_count(vote_hi, vote_lo, valid, group=SOLO):
    """i32 [C]: ``segmented_vote_count``'s tally through scans, with no
    segment sum: the aggregation core of the ring variant.

    After the same sorts, a forward running max carries each run's start
    index and a reversed running min its inclusive end; a run's count is
    the difference of the valid mask's prefix sums at its two ends, so an
    invalid slot sorted into a valid run's tail adds nothing and reads 0,
    as in the segment sum. Equal to ``segmented_vote_count`` on every
    input. On a slot mesh it runs on the all-gathered votes and returns
    the shard's slots.
    """
    if group.size > 1:
        return group.local(scan_vote_count(
            *group.all_gather(vote_hi, vote_lo, valid, dim=-1)), dim=-1)
    c = vote_hi.shape[-1]
    dev = vote_hi.device
    order, sval, starts = _sorted_runs(vote_hi, vote_lo, valid)
    idx = torch.arange(c, device=dev)
    start = torch.cummax(torch.where(starts, idx, -1), dim=0).values
    ends = torch.cat([starts[1:], torch.ones(1, dtype=torch.bool,
                                             device=dev)])
    run_end = torch.flip(torch.cummin(
        torch.flip(torch.where(ends, idx, c), [0]), dim=0).values, [0])
    csum = torch.cumsum(sval, dim=0, dtype=torch.int32)
    base = torch.where(start > 0, csum[(start - 1).clamp(min=0)], 0)
    out = torch.zeros(c, dtype=torch.int32, device=dev)
    out[order] = (csum[run_end] - base) * sval
    return out


def fast_quorum(n_member):
    """i32: the fast quorum ``N - floor((N-1)/4)`` as the reference has
    it (floor division, so N = 0 gives 1; not ``ceil(3N/4)``)."""
    n = torch.as_tensor(n_member)
    return (n - torch.div(n - 1, 4, rounding_mode="floor")).to(torch.int32)


def count_fast_round(vote_hi, vote_lo, valid, n_member, group=SOLO):
    """``(decided, winner_count)``: both the delivered votes and one
    value's votes reach the fast quorum; on a slot mesh the most common
    vote's count and the total are all-reduced."""
    quorum = fast_quorum(n_member)
    winner = group.max(segmented_vote_count(vote_hi, vote_lo, valid,
                                            group).max())
    total = group.sum(valid.sum()).to(torch.int32)
    return (total >= quorum) & (winner >= quorum), winner
