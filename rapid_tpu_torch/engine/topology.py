"""Topology: the K-ring observer/subject graph as index tensors.

Each ring ``k`` orders the slot universe by ``hash64(uid, seed=k)`` with
the uid as tiebreak. The order is static (identities are fixed at boot;
an identifier redraw moves one slot with ``rank_and_insert``), so
``ring_permutations`` sorts once on the host and a view change is
sort-free: gather the member mask into ring order, scan every ring at
once for each position's nearest member before it (``cummax``), and
scatter back. ``build_topology`` takes any number of leading (receiver)
axes on ``member``: the per-receiver engine rebuilds every receiver's
view in one batched call.

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


def _pred_pos(member_s):
    """Ring positions (int64, for the gathers) of each position's last
    member strictly before it, from the mask in ring order
    (``[..., K, C]``): the inclusive ``cummax`` of member positions
    shifted one on. Positions before the ring's first member wrap to its
    last, and an empty view gives 0. A non-member's at-or-before query
    (its gatekeeper) is the same value, as the position itself is no
    member."""
    pos = torch.arange(member_s.shape[-1], dtype=torch.int32,
                       device=member_s.device)
    prev = torch.cummax(torch.where(member_s, pos, -1),
                        dim=-1).values.roll(1, -1)
    last = prev[..., :1].clamp(min=0)
    return torch.where(prev < 0, last, prev).to(torch.int64)


def build_topology(member, ring_order, ring_rank):
    """``(subj_idx, obs_idx, gk_idx, fd_active, fd_first)``, each
    ``[..., C, K]`` for ``member`` of shape ``[..., C]``:

    - ``subj_idx[n, j]`` / ``obs_idx[n, j]``: node n's ring-j predecessor /
      successor among the members (non-member rows point at themselves);
    - ``gk_idx[n, j]``: a non-member's ring-j join gatekeeper;
    - ``fd_active[n, j]``: True on the first ring slot of each unique
      subject; ``fd_first[n, j]`` the first ring slot sharing slot j's
      subject.

    All K rings go through one ``[..., K, C]`` pass: one gather into ring
    order, one scan (``_pred_pos``), and one scatter of the predecessors
    back to slot order through ``ring_order``. ``subj_idx`` is then a
    permutation of the slots (members shifted along each ring,
    non-members fixed), and ``obs_idx`` is its inverse. ``ring_rank``,
    the inverse of ``ring_order``, is not read. Each temporary is dropped
    once used (``del``), which keeps the pass's peak under twice the bytes
    of its outputs.
    """
    c, k = ring_order.shape
    member = member.to(torch.bool)
    dev = member.device
    shape = member.shape[:-1] + (k, c)
    order = ring_order.mT.to(
        torch.int64, memory_format=torch.contiguous_format).expand(shape)
    pg = torch.gather(ring_order.mT.expand(shape), -1, _pred_pos(
        torch.gather(member.unsqueeze(-2).expand(shape), -1, order)))
    pg = pg.scatter(-1, order, pg)
    del order
    slots = torch.arange(c, dtype=torch.int32, device=dev).expand(shape)
    member_k = member.unsqueeze(-2)
    subj = torch.where(member_k, pg, slots)
    gk = torch.where(member_k, slots, pg).mT.contiguous()
    del pg
    # The first ring i with ring j's subject, over [..., K(i), K(j), C]:
    # ring j itself matches, so i <= j.
    ring = torch.arange(k, dtype=torch.int8, device=dev)
    fd_first = torch.where(subj.unsqueeze(-2) == subj.unsqueeze(-3),
                           ring[:, None, None], k).amin(dim=-3).mT.to(
        torch.int32, memory_format=torch.contiguous_format)
    obs = slots.scatter(-1, subj.to(torch.int64), slots).mT.contiguous()
    subj = subj.mT.contiguous()
    usable = member & (member.sum(dim=-1) >= 2)[..., None]
    fd_active = (fd_first == ring) & usable[..., None]
    return subj, obs, gk, fd_active, fd_first


def rebuild(member, ring_order, ring_rank, group=SOLO):
    """``build_topology``'s five tables for the rows of ``group``'s shard
    (every row without a group): the member mask and the ring tables are
    all-gathered, the rebuild runs whole, and the shard keeps its rows."""
    out = build_topology(*group.all_gather(member, ring_order, ring_rank))
    return tuple(group.local(x) for x in out)
