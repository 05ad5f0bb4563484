"""``state.member_map`` on a fleet of one member: the plain call on that
member, against ``torch.func.vmap`` over the same size-1 axis, on the
engine's own maps. Every output is integer or bool: the tolerance is
exact, in value, dtype and shape.

Each case passes host values (settings, a tick, ``with_pos``) and one
passes a ``None`` leaf (``cut.aggregate_device`` with no UP alerts); the
slot-mesh case runs a collective inside the mapped function on two CPU
shards, where the plain call takes the group's unbatched route and
``vmap`` its batched one.
"""
import pytest
import torch
from torch.utils import _pytree

from rapid_tpu_torch import faults as faults_mod
from rapid_tpu_torch.engine import (cut, monitor, receiver, sharding,
                                    state as state_mod, step)
from rapid_tpu_torch.engine.state import (I32_MAX, crash_faults, init_state,
                                          member_map)
from rapid_tpu_torch.identity import default_identities
from rapid_tpu_torch.settings import Settings

N, TICKS = 16, 112
SETTINGS = Settings()


def _vmap(fn, *args):
    """``fn`` under ``torch.func.vmap`` over the leading axis of every
    tensor in ``args``: what ``member_map`` runs for more than one
    member."""
    leaves, spec = _pytree.tree_flatten(args)
    at = [i for i, leaf in enumerate(leaves) if torch.is_tensor(leaf)]

    def one(*tensors):
        full = list(leaves)
        for i, leaf in zip(at, tensors):
            full[i] = leaf
        return fn(*_pytree.tree_unflatten(full, spec))

    return torch.func.vmap(one)(*[leaves[i] for i in at])


def _assert_same(got, want):
    xs, ys = _pytree.tree_leaves(got), _pytree.tree_leaves(want)
    assert len(xs) == len(ys)
    for k, (x, y) in enumerate(zip(xs, ys)):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


def _one(tree):
    return _pytree.tree_map(
        lambda x: x[None] if torch.is_tensor(x) else x, tree)


@pytest.fixture(scope="module")
def shared():
    """A 16-slot cluster one tick before its view change (slot 2 crashed
    at tick 3: reports in the detector, a proposal announced), stacked
    as a fleet of one, with its faults and the tick's source-alive
    mask."""
    uids, id_fp_sum = default_identities(N)
    crash = [I32_MAX] * N
    crash[2] = 3
    faults = crash_faults(crash, device="cpu")
    state, _ = step.simulate(init_state(uids, id_fp_sum, SETTINGS,
                                        device="cpu"),
                             faults, TICKS, SETTINGS, device="cpu")
    assert bool(state.reports.any()) and bool(state.proposal.any())
    alive = ~monitor.crashed_at(faults, TICKS + 1)
    return _one(state), _one(faults), _one(alive)


def _monitor(state, faults, alive):
    return (lambda s, fl: monitor.monitor_tick(s, fl, SETTINGS, TICKS + 1),
            (state, faults))


def _aggregate(state, faults, alive):
    down = member_map(cut.deliver_reports, state, alive)
    return (lambda s, d, u, a: cut.aggregate_device(s, d, u, a, SETTINGS),
            (state, down, None, torch.ones(1, dtype=torch.bool)))


def _view_change(with_pos):
    def case(state, faults, alive):
        return (lambda s, p: step._view_change(s, p, with_pos),
                (state, state.proposal))
    return case


MAPS = {"monitor_tick": _monitor, "aggregate_device": _aggregate,
        "view_change": _view_change(False),
        "view_change_with_pos": _view_change(True)}


@pytest.mark.parametrize("name", list(MAPS))
def test_one_member_equals_vmap(shared, name):
    fn, args = MAPS[name](*shared)
    _assert_same(member_map(fn, *args), _vmap(fn, *args))


def test_dense_receiver_tick_equals_vmap():
    """``receiver._tick`` with every row masked (``dense=True``, the
    fleet's map) at a tick of the crash-window-delay schedule."""
    settings = Settings()
    member = receiver.lower_receiver_schedule(
        faults_mod.crash_window_delay_schedule(16), settings, device="cpu")
    rs, flt = _one(member.state), _one(member.faults)
    for t0 in range(6):
        rs, _ = receiver.fleet_step(rs, flt, settings, t0)
    t = 7
    crashed, planes, acc = receiver._deliver_all(rs, flt, t, settings)
    fn = lambda r, fl, cr, pl, a: receiver._tick(r, fl, settings, t, cr, pl,
                                                 a, True)
    args = (rs, flt, crashed, planes, acc)
    _assert_same(member_map(fn, *args), _vmap(fn, *args))


def test_one_member_on_a_slot_mesh_equals_vmap(shared):
    """Two CPU shards: the mapped function gathers ``pending_deliver``
    and all-reduces its counts through the shard's ``SlotGroup``; every
    shard's plain call equals its ``vmap``, which trades the same values
    batched."""
    state, _, alive = shared
    mesh = sharding.slot_mesh(2, device="cpu")
    parts = sharding.fleet_shard_put(state, mesh, N)
    assert len(parts.shards) == 2
    any_receiver = torch.ones(1, dtype=torch.bool)

    def body(group, shard):
        fn = lambda s, a, r: cut.aggregate_device(
            s, cut.deliver_reports(s, a, group), None, r, SETTINGS, group)
        args = (shard, alive, any_receiver)
        return member_map(fn, *args), _vmap(fn, *args)

    outs = sharding.run_spmd(body, parts)
    for got, want in outs:
        _assert_same(got, want)
    whole = member_map(lambda s, a, r: cut.aggregate_device(
        s, cut.deliver_reports(s, a), None, r, SETTINGS), state, alive,
        any_receiver)
    joined = state_mod.join_slots([o[0] for o in outs], parts.devices[0],
                                  fleet=True)
    _assert_same(joined, whole)
