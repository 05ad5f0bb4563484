"""Topology: the K-ring observer/subject graph as index tensors.

Each ring ``k`` orders the slot universe by ``hash64(uid, seed=k)`` with
the uid as tiebreak. The order is static (identities are fixed at boot;
an identifier redraw moves one slot with ``rank_and_insert``), so
``ring_permutations`` sorts once on the host and a view change is
sort-free: gather the member mask into ring order, scan for each
position's nearest member before and after it (``cummax``/``cummin``),
and gather back. ``build_topology`` takes any number of leading
(receiver) axes on ``member``: the per-receiver engine rebuilds every
receiver's view in one batched call.

On a slot mesh the rebuild stays replicated, as the reference pins it:
``rebuild`` all-gathers the member mask and the ring tables, runs
``build_topology`` on the whole universe and keeps the shard's rows.
"""
from __future__ import annotations

import numpy as np
import torch

from rapid_tpu_torch import hashing
from rapid_tpu_torch.engine.sharding import SOLO


def ring_permutations(uid_hi, uid_lo, k: int):
    """The static per-ring sort on the host: ``(ring_order, ring_rank)``,
    each int32 numpy ``[C, K]``. ``ring_order[p, j]`` is the slot at
    position ``p`` of ring ``j``; ``ring_rank`` is its inverse. Key:
    ``hash64(uid, seed=ring)`` primary, uid tiebreak."""
    uid_hi = uid_hi.cpu()
    uid_lo = uid_lo.cpu()
    c = uid_hi.shape[0]
    hi_np, lo_np = uid_hi.numpy(), uid_lo.numpy()
    pos = np.arange(c, dtype=np.int32)
    orders, ranks = [], []
    for ring in range(k):
        khi, klo = hashing.hash64_limbs(uid_hi, uid_lo, seed=ring)
        order = np.lexsort((lo_np, hi_np, klo.numpy(),
                            khi.numpy())).astype(np.int32)
        rank = np.empty_like(order)
        rank[order] = pos
        orders.append(order)
        ranks.append(rank)
    return np.stack(orders, axis=1), np.stack(ranks, axis=1)


def rank_and_insert(slot: int, uid_hi, uid_lo, ring_order, ring_rank):
    """``(ring_order, ring_rank)`` after slot ``slot``'s identifier redraw,
    without a sort. ``uid_hi``/``uid_lo`` already carry the slot's new
    limbs. Per ring the slot's new position is the count of smaller keys
    (``hash64(uid, seed=ring)``, then the uid; keys are unique), the
    positions between its old and new one shift by one, and the order is
    the inverse permutation, scattered in O(C)."""
    c, k = ring_order.shape
    pos = torch.arange(c, dtype=torch.int32, device=ring_rank.device)
    orders, ranks = [], []
    for ring in range(k):
        khi, klo = hashing.hash64_limbs(uid_hi, uid_lo, seed=ring)
        skhi, sklo = khi[slot], klo[slot]
        suhi, sulo = uid_hi[slot], uid_lo[slot]
        less = (khi < skhi) | ((khi == skhi) & (
            (klo < sklo) | ((klo == sklo) & (
                (uid_hi < suhi) | ((uid_hi == suhi) & (uid_lo < sulo))))))
        r_new = less.sum().to(torch.int32)
        rank = ring_rank[:, ring]
        r_old = rank[slot]
        shift_down = ((rank > r_old) & (rank <= r_new)).to(torch.int32)
        shift_up = ((rank >= r_new) & (rank < r_old)).to(torch.int32)
        rank = rank - shift_down + shift_up
        rank = torch.where(pos == slot, r_new, rank)
        ranks.append(rank)
        orders.append(torch.zeros_like(rank).scatter_(0, rank.long(), pos))
    return torch.stack(orders, dim=1), torch.stack(ranks, dim=1)


def _pred_succ_pos(member_s, n):
    """Nearest-member ring positions from the mask in ring order
    (``[..., C]``): ``pgpos[p]`` is the last member strictly before ``p``
    (members) or at-or-before ``p`` (non-members), ``succpos[p]`` the first
    member strictly after ``p``; both wrap, and an empty view gives 0."""
    c = member_s.shape[-1]
    pos = torch.arange(c, dtype=torch.int64, device=member_s.device)
    lead = member_s.shape[:-1]
    prev_incl = torch.cummax(
        torch.where(member_s, pos, -1), dim=-1).values
    prev_excl = torch.cat(
        [torch.full(lead + (1,), -1, dtype=torch.int64,
                    device=member_s.device), prev_incl[..., :-1]], dim=-1)
    pgpos = torch.where(member_s, prev_excl, prev_incl)
    lastf = torch.where(n > 0, prev_incl[..., -1], 0)
    pgpos = torch.where(pgpos < 0, lastf[..., None], pgpos)
    next_incl = torch.cummin(
        torch.where(member_s, pos, c).flip(-1), dim=-1).values.flip(-1)
    next_excl = torch.cat(
        [next_incl[..., 1:], torch.full(lead + (1,), c, dtype=torch.int64,
                                        device=member_s.device)], dim=-1)
    firstf = torch.where(n > 0, next_incl[..., 0], 0)
    succpos = torch.where(next_excl >= c, firstf[..., None], next_excl)
    return pgpos, succpos


def build_topology(member, ring_order, ring_rank):
    """``(subj_idx, obs_idx, gk_idx, fd_active, fd_first)``, each
    ``[..., C, K]`` for ``member`` of shape ``[..., C]``:

    - ``subj_idx[n, j]`` / ``obs_idx[n, j]``: node n's ring-j predecessor /
      successor among the members (non-member rows point at themselves);
    - ``gk_idx[n, j]``: a non-member's ring-j join gatekeeper;
    - ``fd_active[n, j]``: True on the first ring slot of each unique
      subject; ``fd_first[n, j]`` the first ring slot sharing slot j's
      subject.
    """
    c, k = ring_order.shape
    member = member.to(torch.bool)
    n = member.sum(dim=-1)
    slots = torch.arange(c, dtype=torch.int64, device=member.device)
    order_all = ring_order.to(torch.int64)
    rank_all = ring_rank.to(torch.int64)
    subj_cols, obs_cols, gk_cols = [], [], []
    for ring in range(k):
        order = order_all[:, ring]
        rank = rank_all[:, ring]
        pgpos, succpos = _pred_succ_pos(member[..., order], n)
        pg = order[pgpos[..., rank]]
        succ = order[succpos[..., rank]]
        subj_cols.append(torch.where(member, pg, slots).to(torch.int32))
        obs_cols.append(torch.where(member, succ, slots).to(torch.int32))
        gk_cols.append(torch.where(member, slots, pg).to(torch.int32))
    usable = member & (n >= 2)[..., None]
    fd_first_cols, fd_active_cols = [], []
    for j in range(k):
        first = torch.full_like(subj_cols[j], j)
        for i in range(j - 1, -1, -1):
            first = torch.where(subj_cols[i] == subj_cols[j], i, first)
        fd_first_cols.append(first)
        fd_active_cols.append((first == j) & usable)
    stack = lambda cols: torch.stack(cols, dim=-1)
    return (stack(subj_cols), stack(obs_cols), stack(gk_cols),
            stack(fd_active_cols), stack(fd_first_cols))


def rebuild(member, ring_order, ring_rank, group=SOLO):
    """``build_topology``'s five tables for the rows of ``group``'s shard
    (every row without a group): the member mask and the ring tables are
    all-gathered, the rebuild runs whole, and the shard keeps its rows."""
    out = build_topology(*group.all_gather(member, ring_order, ring_rank))
    return tuple(group.local(x) for x in out)
