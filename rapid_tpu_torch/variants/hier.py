"""Two-level hierarchical consensus: seeded groups and a group verdict.

Every slot hashes into one of ``G = max(2, isqrt(capacity))`` groups by
its identity (``group_ids``). A fast round decides when at least
``fast_quorum(G_nonempty)`` non-empty groups each gather their own fast
quorum over their members (``hier_count_fast_round``). One exchange
costs an intra-group vote per voter, ``G_live**2`` verdict messages among
the live group aggregators and one relayed verdict per target
(``hier_exchange_messages``). Per-group counts are a ``scatter_add``
over the slots, where the reference builds a ``[G, C]`` one-hot.
``np_hier_decide`` is the numpy host twin of the decide bit, by
``bincount``. On a slot mesh (``group``) each shard counts its slots
and the ``[G]`` counts and the sums are all-reduced.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from rapid_tpu_torch import hashing
from rapid_tpu_torch.engine import votes
from rapid_tpu_torch.engine.sharding import SOLO

#: Seed of the identity -> group hash ("hier" in ASCII).
HIER_GROUP_SEED = 0x68696572


def hier_group_count(capacity: int) -> int:
    """The number of groups G for a slot capacity."""
    return max(2, math.isqrt(capacity))


def group_ids(uid_hi, uid_lo, n_groups: int):
    """i32 [C]: each slot's group, hashed from its uid limbs."""
    _, lo = hashing.hash64_limbs(uid_hi, uid_lo, seed=HIER_GROUP_SEED)
    return (lo % n_groups).to(torch.int32)


def _group_counts(gid, mask, n_groups: int):
    """i32 [G]: the slots of ``mask`` in each group, an int32
    ``scatter_add`` (exact in any order of accumulation), out of place
    so a fleet maps it over its members."""
    return torch.zeros(n_groups, dtype=torch.int32,
                       device=gid.device).scatter_add(
        0, gid.long(), mask.to(torch.int32))


def hier_count_fast_round(member, valid, gid, n_groups: int, group=SOLO):
    """``(decided, tally)``: the two-level decide rule over the
    announce-time ``member`` mask and the delivered ``valid`` votes, with
    ``gid`` from ``group_ids``; ``tally`` is the total of delivered
    votes."""
    m_g, v_g, tally = group.sum(
        _group_counts(gid, member, n_groups),
        _group_counts(gid, valid, n_groups), valid.sum())
    group_yes = (v_g >= votes.fast_quorum(m_g)) & (m_g > 0)
    n_live = (m_g > 0).sum().to(torch.int32)
    decided = group_yes.sum().to(torch.int32) >= votes.fast_quorum(n_live)
    return decided, tally.to(torch.int32)


def np_hier_decide(member_mask, valid_mask, uid_hi, uid_lo,
                   n_groups: int) -> bool:
    """The decide bit of ``hier_count_fast_round`` on numpy masks and
    uint32 uid limbs, with ``bincount``."""
    limb = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    gid = group_ids(limb(uid_hi), limb(uid_lo), n_groups).numpy()
    m_g = np.bincount(gid, weights=np.asarray(member_mask, np.int64),
                      minlength=n_groups).astype(np.int64)
    v_g = np.bincount(gid, weights=np.asarray(valid_mask, np.int64),
                      minlength=n_groups).astype(np.int64)
    quorum_g = m_g - (m_g - 1) // 4
    group_yes = (v_g >= quorum_g) & (m_g > 0)
    n_live = int((m_g > 0).sum())
    return int(group_yes.sum()) >= n_live - (n_live - 1) // 4


def hier_exchange_messages(voters, relay_targets, gid, n_groups: int,
                           group=SOLO):
    """i32: messages of one hierarchical exchange: a vote per voter,
    ``G_live**2`` verdicts among the groups holding a voter, a relayed
    verdict per target; ``gid`` from ``group_ids``."""
    counts, n_voters, n_relay = group.sum(
        _group_counts(gid, voters, n_groups), voters.sum(),
        relay_targets.sum())
    g_live = (counts > 0).sum().to(torch.int32)
    return (n_voters.to(torch.int32) + g_live * g_live
            + n_relay.to(torch.int32))
