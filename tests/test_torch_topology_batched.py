"""The port's one-pass K-ring rebuild (``topology.build_topology``)
against the reference's NumPy backend, and the number of aten ops one
rebuild issues.

Exactness: all five tables, dtype for dtype, for K of 3 and 10 and C of
1 to 1,024 (and the receiver boot's 24 at K=10); views empty, of one
and two members, full, drawn at random, and booted with dormant slots
(the churn cell's ``member=`` mask); ring tables from the boot sort,
after an identifier redraw (``rank_and_insert``) and from the receiver
boot's default identities; no leading axis, a leading receiver axis
with shared tables, and a fleet of 3 under ``member_map`` with
per-member tables. Everything is integer or bool: the tolerance is exact."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rapid_tpu import hashing as ref_hashing
from rapid_tpu.engine import topology as ref_topology

from rapid_tpu_torch.engine import topology
from rapid_tpu_torch.engine.state import member_map
from rapid_tpu_torch.identity import default_identities, synthetic_uids

#: aten ops (nested ones included) of one rebuild at C=256, K=10, as the
#: CPU profiler counts them: the one-pass rebuild's count, plain and under
#: ``member_map`` with F=4. The per-ring loop it replaced issued 1,690 and
#: 2,575.
ATEN_OPS = {"plain": 162, "member_map": 173}


def _limbs(uids):
    hi, lo = ref_hashing.np_to_limbs(np.asarray(uids, dtype=np.uint64))
    return (torch.from_numpy(hi.astype(np.int64)),
            torch.from_numpy(lo.astype(np.int64)))


def _tables(c, k, seed, universe):
    """``(ring_order, ring_rank)`` of a c-slot universe: seeded synthetic
    identities (``boot``), the same after one slot's identifier redraw
    (``redrawn``), or the receiver boot's default identities
    (``default``)."""
    uids = (default_identities(c)[0] if universe == "default"
            else synthetic_uids(c, seed))
    hi, lo = _limbs(uids)
    order, rank = (torch.from_numpy(t)
                   for t in topology.ring_permutations(hi, lo, k))
    if universe == "redrawn":
        slot = seed % c
        new_hi, new_lo = _limbs(synthetic_uids(c + 1, seed + 1)[-1:])
        hi[slot], lo[slot] = new_hi[0], new_lo[0]
        order, rank = topology.rank_and_insert(slot, hi, lo, order, rank)
    return order, rank


def _views(c, seed):
    """Member masks ``[V, c]``: empty, one member, two members (the ring's
    ends), full, two random draws, and the first ``c - c // 8`` slots with
    the rest dormant."""
    rng = np.random.default_rng(seed)
    one = np.zeros(c, bool)
    one[c // 2] = True
    two = np.zeros(c, bool)
    two[[0, c - 1]] = True
    views = [np.zeros(c, bool), one, two, np.ones(c, bool),
             rng.random(c) < 0.5, rng.random(c) < 0.97,
             np.arange(c) < c - c // 8]
    return np.stack(views)


def _check(got, member, order, rank):
    want = ref_topology.build_topology(np, member, order.numpy(),
                                       rank.numpy())
    for name, g, w in zip(("subj_idx", "obs_idx", "gk_idx", "fd_active",
                           "fd_first"), got, want):
        w = np.asarray(w)
        assert g.is_contiguous(), name
        assert g.numpy().dtype == w.dtype, name
        assert np.array_equal(g.numpy(), w), name


@pytest.mark.parametrize("universe", ["boot", "redrawn", "default"])
@pytest.mark.parametrize("layout", ["plain", "rows", "fleet"])
@pytest.mark.parametrize("k,c", [(k, c) for k in (3, 10)
                                 for c in (1, 2, 64, 1024)] + [(10, 24)])
def test_batched_topology_equals_reference(k, c, layout, universe):
    views = _views(c, seed=c + k)
    order, rank = _tables(c, k, seed=c * k, universe=universe)
    if layout == "plain":
        for member in views:
            _check(topology.build_topology(torch.from_numpy(member), order,
                                           rank), member, order, rank)
    elif layout == "rows":
        got = topology.build_topology(torch.from_numpy(views), order, rank)
        for r, member in enumerate(views):
            _check([x[r] for x in got], member, order, rank)
    else:
        tables = [_tables(c, k, seed=c * k + f, universe=universe)
                  for f in range(3)]
        orders = torch.stack([t[0] for t in tables])
        ranks = torch.stack([t[1] for t in tables])
        for start in range(0, len(views) - 2):
            members = views[start:start + 3]
            got = member_map(topology.build_topology,
                             torch.from_numpy(members), orders, ranks)
            for f, member in enumerate(members):
                _check([x[f] for x in got], member,
                       orders[f], ranks[f])


def _aten_ops(fn):
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.name.startswith("aten::") for e in prof.events())


@pytest.mark.parametrize("mode", sorted(ATEN_OPS))
def test_rebuild_aten_ops(mode):
    c, k = 256, 10
    gen = torch.Generator().manual_seed(5)
    if mode == "plain":
        order, rank = _tables(c, k, seed=1, universe="boot")
        member = torch.rand(c, generator=gen) < 0.6
        count = _aten_ops(lambda: topology.build_topology(member, order,
                                                          rank))
    else:
        tables = [_tables(c, k, seed=1 + f, universe="boot")
                  for f in range(4)]
        orders = torch.stack([t[0] for t in tables])
        ranks = torch.stack([t[1] for t in tables])
        members = torch.rand(4, c, generator=gen) < 0.6
        count = _aten_ops(lambda: member_map(topology.build_topology,
                                             members, orders, ranks))
    assert count <= ATEN_OPS[mode], (mode, count)
