"""The port's meshes (``rapid_tpu_torch.engine.sharding``) against the
reference's, which run on the conftest's eight forced CPU devices.

- The spec functions give the reference's spec for every shape of a grid
  and every case of ``tests/test_sharding.py`` and
  ``tests/test_receiver.py``, on meshes of 1, 2, 4 and 8 devices.
- F=8 shared fleets (N=16, 80 ticks, ``random_adversary_schedule`` seeds
  0-7) split over port meshes of 8, 4 and 2 CPU entries equal the
  reference's ``fleet_simulate`` on its 8-way fleet mesh; so do the
  per-receiver partition and flip-flop fleet of
  ``test_fleet_axis_parity_receiver_f8`` on the dense and the packed
  carry, an F=6 fleet that does not divide an 8-way mesh, and a
  reference fleet placed on its mesh and carried across by
  ``convert.from_reference``.
- Slot meshes: ``simulate``, ``step`` and ``run_differential`` on one
  device and on two equal the reference with and without its 8-way slot
  mesh; ``shard_put`` on two devices holds the slots the reference's
  two-way placement puts on each; a fleet on a slot mesh of two equals
  the unsplit fleet, ``fleet_shard_put`` splits each member's slots (one
  whole shard where they do not divide the mesh), and both layouts
  together are "mutually exclusive". ``tests/test_torch_slot_mesh.py``
  and ``tests/test_torch_fleet_slot_mesh.py`` hold the slot axis at more
  sizes.
- The shard loops enter each shard's device context around each of its
  ticks, in turns.

Everything is integer or bool: the tolerance is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from rapid_tpu import faults as ref_faults
from rapid_tpu.engine import diff as ref_diff
from rapid_tpu.engine import fleet as ref_fleet
from rapid_tpu.engine import sharding as ref_sharding
from rapid_tpu.engine import state as ref_state
from rapid_tpu.engine.paxos import synthetic_contested_schedule as \
    ref_contested
from rapid_tpu.engine.step import simulate as ref_simulate
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import faults
from rapid_tpu_torch.convert import from_reference, to_numpy
from rapid_tpu_torch.engine import (diff, fleet, receiver, rx_packed,
                                    sharding, step)
from rapid_tpu_torch.engine.state import ReceiverState
from rapid_tpu_torch.engine.step import simulate
from rapid_tpu_torch.settings import Settings

N, TICKS, F = 16, 80, 8


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref_meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest-forced 8-device CPU mesh")
    return {n: (ref_sharding.slot_mesh(n), ref_sharding.fleet_axis_mesh(n))
            for n in (1, 2, 4, 8)}


def _assert_same(port_nt, ref_nt, what, fields=None):
    port_np = to_numpy(port_nt)
    for name in fields or ref_nt._fields:
        want = np.asarray(getattr(ref_nt, name))
        got = np.asarray(getattr(port_np, name))
        assert got.dtype == want.dtype and got.shape == want.shape, \
            f"{what}.{name}"
        if not np.array_equal(got, want):
            first = np.argwhere(got != want)[0].tolist() if got.ndim else []
            pytest.fail(f"{what}.{name} differs first at {first}")


# ---------------------------------------------------------------------------
# spec functions
# ---------------------------------------------------------------------------

#: (shape, capacity) pairs: every case of the reference's spec tests, and
#: a grid of ranks, positions and divisibility.
SPEC_CASES = [
    ((64,), 64), ((64, 10), 64), ((3, 64), 64), ((2, 5, 64), 64), ((), 64),
    ((256, 8), 64), ((60,), 60), ((32,), 32), ((32, 32), 32),
    ((4, 16, 16), 16), ((4, 16, 16, 10), 16), ((4,), 16), ((16, 16), 16),
    ((4, 12, 12), 12), ((8,), 8), ((8, 24, 24), 8), ((6, 24), 6),
    ((256, 8), 8), ((), 8), ((6, 6, 6), 6), ((2, 3), 3), ((7, 14, 14), 14),
    ((1, 8, 2), 8), ((5, 4, 8, 8), 8),
]


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_spec_functions_equal_the_reference(ref_meshes, n_dev):
    ref_slot, ref_fleet_mesh = ref_meshes[n_dev]
    slot = sharding.slot_mesh(n_dev, device="cpu")
    fleet_mesh = sharding.fleet_axis_mesh(n_dev, device="cpu")
    assert sharding.mesh_size(slot) == ref_sharding.mesh_size(ref_slot)
    for shape, c in SPEC_CASES:
        for port_fn, ref_fn, mesh, ref_mesh in (
                (sharding.spec_for, ref_sharding.spec_for, slot, ref_slot),
                (sharding.fleet_spec_for, ref_sharding.fleet_spec_for, slot,
                 ref_slot),
                (sharding.fleet_axis_spec_for,
                 ref_sharding.fleet_axis_spec_for, fleet_mesh,
                 ref_fleet_mesh)):
            want = ref_fn(shape, c, ref_mesh)
            assert isinstance(want, P)
            assert port_fn(shape, c, mesh) == tuple(want), \
                (port_fn.__name__, shape, c, n_dev)


def test_sharding_and_state_shardings_equal_the_reference(ref_meshes):
    from rapid_tpu_torch.engine.state import init_state
    from rapid_tpu_torch.identity import default_identities

    ref_slot = ref_meshes[8][0]
    slot = sharding.slot_mesh(8, device="cpu")
    uids, fp_sum = default_identities(32)
    state = init_state(uids, fp_sum, Settings(), device="cpu")
    got = sharding.state_shardings(state, slot)
    want = ref_sharding.state_shardings(
        ref_state.init_state(uids, fp_sum, RefSettings()), ref_slot)
    for name, a, b in zip(state._fields, got, want):
        assert a.spec == tuple(b.spec) and a.mesh is slot, name
    x = torch.zeros(3, 32)
    assert sharding.sharding_for(x, 32, slot).spec == tuple(
        ref_sharding.sharding_for(np.zeros((3, 32)), 32, ref_slot).spec)
    for fn in (sharding.constrain, sharding.constrain_tree):
        assert fn(x, slot, 32) is x
    assert sharding.replicate(x, slot) is x
    assert sharding.fleet_axis_constrain_tree(x, slot, 3) is x
    with pytest.raises(ValueError, match="all-scalar"):
        sharding.shard_put((1, 2), sharding.slot_mesh(1, device="cpu"))
    placed = sharding.fleet_shard_put(state, sharding.slot_mesh(
        1, device="cpu"), 32)
    assert all(torch.equal(a, b) for a, b in zip(placed, state))


def test_meshes_and_their_refusals():
    from rapid_tpu_torch import engine

    assert engine.slot_mesh is sharding.slot_mesh
    slot = sharding.slot_mesh(8, device="cpu")
    assert slot.shape == {sharding.AXIS: 8}
    assert hash(slot) == hash(sharding.slot_mesh(8, device="cpu"))
    mesh = sharding.fleet_axis_mesh(devices=["cpu"] * 3)
    assert mesh.shape == {sharding.FLEET_AXIS: 3}
    assert sharding.fleet_axis_mesh(2, devices=["cpu"] * 3).devices == \
        (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="need 4 devices for the fleet "
                                         "mesh, have 3"):
        sharding.fleet_axis_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="need 2 devices for the slot"):
        sharding.slot_mesh(2, devices=["cpu"])
    # A fleet on a slot mesh: four slots do not divide eight devices, so
    # the tensor is one whole shard on the first (the reference
    # replicates it); eight slots split one a shard, the member axis whole.
    whole = sharding.fleet_shard_put(torch.zeros(4), slot, 4)
    assert isinstance(whole, sharding.SlotShards)
    assert whole.devices == slot.devices[:1] and len(whole.shards) == 1
    assert torch.equal(whole.shards[0], torch.zeros(4))
    x = torch.arange(32).reshape(4, 8)
    split = sharding.fleet_shard_put(x, slot, 8)
    assert split.devices == slot.devices and split.capacity == 8
    assert [tuple(part.shape) for part in split.shards] == [(4, 1)] * 8
    assert torch.equal(torch.cat(split.shards, dim=1), x)


def test_shard_put_on_two_devices_holds_the_reference_placement(
        ref_meshes):
    """``shard_put`` of a state and its faults on a two-device slot mesh:
    each shard holds what the reference's two-way placement puts on that
    device, leaf by leaf, and ``state.join_slots`` gives the whole back."""
    from rapid_tpu_torch.engine.state import (crash_faults, init_state,
                                              join_slots)
    from rapid_tpu_torch.identity import default_identities

    n = 32
    uids, fp_sum = default_identities(n)
    crash = [ref_state.I32_MAX] * n
    crash[5] = 3
    ref_mesh = ref_meshes[2][0]
    two = sharding.slot_mesh(2, device="cpu")
    for port_tree, ref_tree in (
            (init_state(uids, fp_sum, Settings(), device="cpu"),
             ref_state.init_state(uids, fp_sum, RefSettings())),
            (crash_faults(crash, device="cpu"),
             ref_state.crash_faults(crash))):
        placed = sharding.shard_put(port_tree, two, n)
        ref_placed = ref_sharding.shard_put(ref_tree, ref_mesh, n)
        assert isinstance(placed, sharding.SlotShards)
        assert placed.devices == two.devices and placed.capacity == n
        fields = getattr(type(port_tree), "_fields", ("crash_tick",))
        for k, shard in enumerate(placed.shards):
            host = to_numpy(shard) if hasattr(shard, "_fields") else shard
            for name in fields:
                want = np.asarray(sorted(
                    getattr(ref_placed, name).addressable_shards,
                    key=lambda sh: sh.device.id)[k].data)
                got = np.asarray(getattr(host, name))
                assert got.dtype == want.dtype, name
                assert got.shape == want.shape, name
                assert np.array_equal(got, want), name
        joined = join_slots(placed.shards, torch.device("cpu"))
        for name in fields:
            assert torch.equal(getattr(joined, name),
                               getattr(port_tree, name)), name


def test_fleet_axis_mesh_on_the_card_counts_the_cards(monkeypatch):
    """On "cuda" the mesh takes the visible cards and raises with the
    count when too few are there, before any tensor is placed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    mesh = sharding.fleet_axis_mesh()
    assert mesh.devices == (torch.device("cuda", 0),)
    assert sharding.fleet_axis_mesh(1).devices == mesh.devices
    with pytest.raises(ValueError, match="need 2 devices for the fleet "
                                         "mesh, have 1"):
        sharding.fleet_axis_mesh(2)
    with pytest.raises(ValueError, match="need 3 devices for the slot"):
        sharding.slot_mesh(3)


# ---------------------------------------------------------------------------
# fleet meshes: shared fleets
# ---------------------------------------------------------------------------

_REF = {}


def _shared_members(pkg, mod, f=F, ticks=TICKS, **kw):
    settings = (Settings if mod is fleet else RefSettings)()
    return [mod.lower_schedule(pkg.random_adversary_schedule(N, s, ticks),
                               settings, **kw) for s in range(f)]


def _ref_shared(ref_meshes, f):
    """The reference's F-member fleet on its 8-way fleet mesh."""
    key = ("shared", f)
    if key not in _REF:
        mesh = ref_meshes[8][1]
        stacked = ref_fleet.stack_members(_shared_members(ref_faults,
                                                          ref_fleet, f))
        placed = ref_sharding.fleet_axis_put(stacked, mesh, f)
        _REF[key] = (placed, ref_fleet.fleet_simulate(
            placed, TICKS, RefSettings(), fleet_mesh=mesh))
    return _REF[key]


@pytest.mark.parametrize("n_dev", [8, 4, 2])
def test_shared_fleet_on_fleet_mesh_equals_the_reference(ref_meshes, n_dev):
    _, (want_finals, want_logs) = _ref_shared(ref_meshes, F)
    stacked = fleet.stack_members(_shared_members(faults, fleet,
                                                  device="cpu"))
    mesh = sharding.fleet_axis_mesh(n_dev, device="cpu")
    put = sharding.fleet_axis_put(stacked, mesh, F)
    assert len(put.shards) == n_dev and put.fleet_size == F
    assert put.shards[1].state.member.shape[0] == F // n_dev
    for got in (fleet.fleet_simulate(stacked, TICKS, Settings(),
                                     fleet_mesh=mesh, device="cpu"),
                fleet.fleet_simulate(put, TICKS, Settings(), device="cpu")):
        _assert_same(got[1], want_logs, "logs")
        _assert_same(got[0], want_finals, "finals")


def test_non_dividing_fleet_replicates_and_equals_the_reference(ref_meshes):
    """F=6 on an 8-way mesh: the reference replicates every leaf; the
    port runs the whole fleet on the mesh's first device."""
    _, (want_finals, want_logs) = _ref_shared(ref_meshes, 6)
    stacked = fleet.stack_members(_shared_members(faults, fleet, 6,
                                                  device="cpu"))
    mesh = sharding.fleet_axis_mesh(8, device="cpu")
    put = sharding.fleet_axis_put(stacked, mesh, 6)
    assert len(put.shards) == 1 and put.devices == mesh.devices[:1]
    finals, logs = fleet.fleet_simulate(stacked, TICKS, Settings(),
                                        fleet_mesh=mesh, device="cpu")
    _assert_same(logs, want_logs, "logs")
    _assert_same(finals, want_finals, "finals")


def test_reference_fleet_on_its_mesh_carries_across(ref_meshes):
    placed, (want_finals, want_logs) = _ref_shared(ref_meshes, F)
    assert tuple(placed.state.member.sharding.spec)[0] == \
        ref_sharding.FLEET_AXIS
    carried = from_reference(placed, device="cpu")
    finals, logs = fleet.fleet_simulate(
        carried, TICKS, Settings(),
        fleet_mesh=sharding.fleet_axis_mesh(8, device="cpu"), device="cpu")
    _assert_same(logs, want_logs, "logs")
    _assert_same(finals, want_finals, "finals")


def test_both_layouts_together_are_mutually_exclusive(ref_meshes):
    stacked = fleet.stack_members(_shared_members(faults, fleet, 2, 40,
                                                  device="cpu"))
    one = sharding.slot_mesh(1, device="cpu")
    two = sharding.fleet_axis_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        step.fleet_body(stacked.state, stacked.faults, stacked.churn,
                        stacked.fallback, 40, Settings(), mesh=one,
                        fleet_mesh=two)
    with pytest.raises(ValueError, match="mutually exclusive"):
        fleet.fleet_simulate(stacked, 40, Settings(), mesh=one,
                             fleet_mesh=two, device="cpu")
    # The reference refuses the same pair with the same words.
    members = ref_fleet.stack_members(_shared_members(ref_faults, ref_fleet,
                                                      2, 40))
    with pytest.raises(ValueError, match="mutually exclusive"):
        ref_fleet.fleet_simulate(members, 40, RefSettings(),
                                 mesh=ref_meshes[8][0],
                                 fleet_mesh=ref_meshes[8][1])
    # A one-device slot mesh runs the fleet where it lies.
    got = fleet.fleet_simulate(stacked, 40, Settings(), mesh=one,
                               device="cpu")
    want = fleet.fleet_simulate(stacked, 40, Settings(), device="cpu")
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    # A slot mesh of two splits every member's slots and equals the
    # unsplit run.
    split = fleet.fleet_simulate(stacked, 40, Settings(),
                                 mesh=sharding.slot_mesh(2, device="cpu"),
                                 device="cpu")
    for part, whole in zip(split, want):
        for a, b in zip(part, whole):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="'fleet' axis"):
        fleet.fleet_simulate(stacked, 40, Settings(), fleet_mesh=one,
                             device="cpu")


# ---------------------------------------------------------------------------
# fleet meshes: per-receiver fleets, dense and packed
# ---------------------------------------------------------------------------


def _link_schedules(pkg):
    weights = pkg.ScenarioWeights(
        **{k: (1.0 if k in ("partition", "flip_flop") else 0.0)
           for k in pkg.SCENARIO_KINDS})
    return [pkg.sample_adversary_schedule(N, s, TICKS, weights).schedule
            for s in range(F)]


def _ref_receiver(ref_meshes):
    if "receiver" not in _REF:
        mesh = ref_meshes[8][1]
        stacked = ref_fleet.stack_receiver_members(
            [ref_fleet.lower_receiver_schedule(s, RefSettings())
             for s in _link_schedules(ref_faults)])
        _REF["receiver"] = ref_fleet.receiver_fleet_simulate(
            ref_sharding.fleet_axis_put(stacked, mesh, F), TICKS,
            RefSettings(), fleet_mesh=mesh)
    return _REF["receiver"]


@pytest.mark.parametrize("n_dev", [8, 4, 2])
@pytest.mark.parametrize("rx_kernel", ["xla", "packed"])
def test_receiver_fleet_on_fleet_mesh_equals_the_reference(ref_meshes,
                                                           rx_kernel, n_dev):
    want_finals, want_logs = _ref_receiver(ref_meshes)
    settings = Settings(rx_kernel=rx_kernel)
    stacked = fleet.stack_receiver_members(
        [fleet.lower_receiver_schedule(s, settings, device="cpu")
         for s in _link_schedules(faults)])
    finals, logs = fleet.receiver_fleet_simulate(
        stacked, TICKS, settings,
        fleet_mesh=sharding.fleet_axis_mesh(n_dev, device="cpu"),
        device="cpu")
    _assert_same(logs, want_logs, "logs")
    if rx_kernel == "xla":
        assert isinstance(finals, ReceiverState)
        _assert_same(finals, want_finals, "finals")
    else:
        view = receiver.receiver_final_view(finals)
        _assert_same(view, want_finals, "finals", view._fields)
    assert not to_numpy(receiver.receiver_final_view(finals)).flags.any()


# ---------------------------------------------------------------------------
# the shard loops: each shard's tick under its device's context, in turns
# ---------------------------------------------------------------------------


class _Contexts:
    """A stand-in for ``sharding.device_context`` that records how deep
    the shard loop is inside a device context."""

    def __init__(self):
        self.depth = 0
        self.entered = 0

    def __call__(self, dev):
        outer = self

        class _Ctx:
            def __enter__(self):
                outer.depth += 1
                outer.entered += 1

            def __exit__(self, *exc):
                outer.depth -= 1

        return _Ctx()


def test_shared_shards_tick_in_turns_under_their_device(monkeypatch):
    contexts, calls = _Contexts(), []
    fleet_step = step._fleet_step

    def spy(state, faults_, settings, host, churn, fallback):
        calls.append((id(host), contexts.depth, state.member.shape[0]))
        return fleet_step(state, faults_, settings, host, churn, fallback)

    monkeypatch.setattr(sharding, "device_context", contexts)
    monkeypatch.setattr(step, "_fleet_step", spy)
    stacked = fleet.stack_members(_shared_members(faults, fleet, 4, 6,
                                                  device="cpu"))
    fleet.fleet_simulate(stacked, 5, Settings(), device="cpu",
                         fleet_mesh=sharding.fleet_axis_mesh(
                             4, device="cpu"))
    hosts = [c[0] for c in calls]
    assert len(calls) == 20 and len(set(hosts)) == 4
    assert hosts == hosts[:4] * 5
    assert {(d, f) for _, d, f in calls} == {(1, 1)}
    assert contexts.entered == 4 + 20      # each host's boot, each tick


@pytest.mark.parametrize("rx_kernel", ["xla", "packed"])
def test_receiver_shards_tick_in_turns_under_their_device(monkeypatch,
                                                          rx_kernel):
    contexts, calls = _Contexts(), []
    fleet_step = receiver.fleet_step

    def spy(rs, faults_, settings, tick):
        calls.append((tick, contexts.depth, rs.member.shape[0]))
        return fleet_step(rs, faults_, settings, tick)

    monkeypatch.setattr(sharding, "device_context", contexts)
    monkeypatch.setattr(receiver, "fleet_step", spy)
    settings = Settings(rx_kernel=rx_kernel)
    stacked = fleet.stack_receiver_members(
        [fleet.lower_receiver_schedule(s, settings, device="cpu")
         for s in _link_schedules(faults)[:4]])
    loop = (rx_packed.dense_fleet_simulate if rx_kernel == "xla"
            else rx_packed.fleet_simulate)
    loop(stacked.state, stacked.faults, 3, settings,
         fleet_mesh=sharding.fleet_axis_mesh(2, device="cpu"))
    assert [c[0] for c in calls] == [0, 0, 1, 1, 2, 2]
    assert {(d, f) for _, d, f in calls} == {(1, 2)}
    assert contexts.entered == 2 + 6       # each shard's start tick read


# ---------------------------------------------------------------------------
# a one-device slot mesh on the shared engine
# ---------------------------------------------------------------------------


def test_run_differential_on_a_one_device_slot_mesh(ref_meshes):
    port = diff.run_differential(
        16, {2: 3}, 130, mesh=sharding.slot_mesh(1, device="cpu"),
        device="cpu")
    port.assert_identical()
    for mesh in (None, ref_meshes[8][0]):
        want = ref_diff.run_differential(16, {2: 3}, 130, mesh=mesh)
        assert [dataclasses.astuple(e) for e in port.engine_events] == \
            [dataclasses.astuple(e) for e in want.engine_events]
        assert port.engine_counters == want.engine_counters
        assert port.engine_config_id == want.engine_config_id
    two = diff.run_differential(16, {2: 3}, 130, device="cpu",
                                mesh=sharding.slot_mesh(2, device="cpu"))
    assert two.engine_counters == port.engine_counters
    assert two.engine_events == port.engine_events
    assert two.engine_config_id == port.engine_config_id
    got = diff.run_variant_differential(
        16, {2: 3}, 130, "ring", mesh=sharding.slot_mesh(1, device="cpu"),
        device="cpu")
    got.assert_identical()


def test_simulate_on_a_one_device_slot_mesh(ref_meshes):
    """The contested scenario of ``tests/test_sharding.py``: the port on
    ``slot_mesh(1)`` equals the reference with and without its 8-way
    mesh, logs and final state."""
    from rapid_tpu_torch.engine.state import crash_faults, init_state

    from rapid_tpu import hashing as ref_hashing

    n, ticks = 16, 120
    hi, lo = ref_hashing.np_to_limbs(np.arange(1, n + 1, dtype=np.uint64))
    hi, lo = ref_hashing.hash64_limbs(np, hi, lo, seed=0xBEEF)
    uids = [int(u) for u in ref_hashing.np_from_limbs(hi, lo)]
    ref_settings = RefSettings()
    schedule, _ = ref_contested(n, ref_settings, ticks, uids=uids)
    ref_st = ref_state.init_state(uids, id_fp_sum=0, settings=ref_settings)
    ref_fa = ref_state.crash_faults([ref_state.I32_MAX] * n)
    wants = [ref_simulate(ref_st, ref_fa, ticks, ref_settings,
                          fallback=schedule)]
    mesh8 = ref_meshes[8][0]
    wants.append(ref_simulate(ref_sharding.shard_put(ref_st, mesh8, n),
                              ref_sharding.shard_put(ref_fa, mesh8, n),
                              ticks, ref_settings, fallback=schedule,
                              mesh=mesh8))
    mesh = sharding.slot_mesh(1, device="cpu")
    state = sharding.shard_put(init_state(uids, 0, Settings(), device="cpu"),
                               mesh, n)
    faults_ = sharding.shard_put(crash_faults([ref_state.I32_MAX] * n,
                                              device="cpu"), mesh, n)
    final, logs = simulate(state, faults_, ticks, Settings(),
                           fallback=from_reference(schedule, device="cpu"),
                           mesh=mesh, device="cpu")
    assert int(logs.decide_now.sum()) >= 1
    for want_final, want_logs in wants:
        _assert_same(logs, want_logs, "logs")
        _assert_same(final, want_final, "final")
    two = sharding.slot_mesh(2, device="cpu")
    final, logs = simulate(sharding.shard_put(state, two, n),
                           sharding.shard_put(faults_, two, n), ticks,
                           Settings(),
                           fallback=from_reference(schedule, device="cpu"),
                           mesh=two, device="cpu")
    for want_final, want_logs in wants:
        _assert_same(logs, want_logs, "logs on two devices")
        _assert_same(final, want_final, "final on two devices")
    got = step.step(state, faults_, Settings(), mesh=two)
    want = step.step(state, faults_, Settings())
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
