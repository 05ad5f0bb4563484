"""Fleets on a slot mesh: each member's slots split over D devices
(``sharding.fleet_shard_put``, ``step.fleet_body``,
``fleet.fleet_simulate(mesh=...)``), on entries of the CPU, against the
JAX reference.

- The reference's own case (``tests/test_sharding.py``'s F=4, N=16, 80
  ticks, ``random_adversary_schedule`` seeds 2, 5, 9 and 13) on
  ``slot_mesh(D)`` for D in {2, 4, 8}: logs and finals equal to the
  reference's ``fleet_simulate`` without a mesh; on a 3-way mesh, which
  16 slots do not divide, the fleet runs whole on the first device and
  equals it too.
- A mixed fleet under "hier" with the invariant monitor and a 16-row
  recorder on 4 shards (a crash + window member, a contested member
  decided by the classic chain, a churn member lowered as a campaign
  lowers it, and one whose joiners start dormant and decide through the
  fast round): logs, finals and recorders equal to the reference's.
- F == C under "ring": eight members of eight slots (crash, contested
  and dormant-churn members) on eight shards, the member axis whole,
  equal to the reference's fleet on its own 8-way slot mesh.
- ``fleet_shard_put`` holds, shard by shard and leaf by leaf, what the
  reference's ``fleet_shard_put`` puts on each device.
- Every ``SlotGroup`` collective called under ``torch.func.vmap`` over F
  members equals the same collective called once per member, nested
  ``vmap`` included; a collective skipped under ``vmap`` names the
  caller's line, and a shard that raises fails the fleet with
  ``ShardError``.

Each reference run is made once (the reference's own case in a
module-scoped fixture); the reference compiles a program per settings
and shape, so the cases share settings where they can. Everything is
integer or bool: the tolerance is exact.
"""
import numpy as np
import pytest
import torch

import jax

from rapid_tpu import faults as ref_faults
from rapid_tpu.engine import churn as ref_churn
from rapid_tpu.engine import fleet as ref_fleet
from rapid_tpu.engine import sharding as ref_sharding
from rapid_tpu.engine import state as ref_state
from rapid_tpu.engine.diff import default_endpoints, default_node_ids
from rapid_tpu.oracle.membership_view import id_fingerprint, uid_of
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import faults
from rapid_tpu_torch.convert import to_numpy
from rapid_tpu_torch.engine import churn, fleet, sharding, state, step
from rapid_tpu_torch.settings import Settings

N, TICKS, SEEDS = 16, 80, (2, 5, 9, 13)
#: The mixed fleet: N=16 members in 20 slots (churn headroom).
MIX_N, MIX_C, MIX_TICKS = 16, 20, 20
#: F == C: eight members of eight slots.
FC, FC_TICKS = 8, 20


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
    return {n: ref_sharding.slot_mesh(n) for n in (2, 4, 8)}


def _mesh(d: int):
    return sharding.slot_mesh(d, device="cpu")


def _assert_same(port_nt, ref_nt, what):
    port_np = to_numpy(port_nt)
    for name in ref_nt._fields:
        want = np.asarray(getattr(ref_nt, name))
        got = np.asarray(getattr(port_np, name))
        assert got.dtype == want.dtype and got.shape == want.shape, \
            f"{what}.{name}"
        if not np.array_equal(got, want):
            first = np.argwhere(got != want)[0].tolist() if got.ndim else []
            pytest.fail(f"{what}.{name} differs first at {first}")


def _assert_run(got, want, what):
    _assert_same(got[1], want[1], f"{what} logs")
    _assert_same(got[0], want[0], f"{what} finals")
    assert len(got) == len(want)
    if len(want) == 3:
        _assert_same(got[2], want[2], f"{what} recorders")


# ---------------------------------------------------------------------------
# the reference's own case
# ---------------------------------------------------------------------------


def _base_fleet(pkg, mod, settings, **kw):
    return mod.stack_members([
        mod.lower_schedule(pkg.random_adversary_schedule(N, seed=s,
                                                         ticks=TICKS),
                           settings, **kw) for s in SEEDS])


@pytest.fixture(scope="module")
def base(ref_meshes):
    """The port's stacked fleet and the reference's run of the same
    fleet (the reference's own test holds that run equal to the one on
    its 8-way slot mesh)."""
    ref_settings = RefSettings()
    return {
        "port": _base_fleet(faults, fleet, Settings(), device="cpu"),
        "ref": ref_fleet.fleet_simulate(
            _base_fleet(ref_faults, ref_fleet, ref_settings), TICKS,
            ref_settings),
    }


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_reference_case_on_a_slot_mesh_equals_the_reference(base, n_dev):
    got = fleet.fleet_simulate(base["port"], TICKS, Settings(),
                               mesh=_mesh(n_dev), device="cpu")
    _assert_run(got, base["ref"], f"D={n_dev} against the reference")


def test_non_dividing_capacity_runs_whole_and_equals_the_reference(base):
    """16 slots on a 3-way mesh: ``fleet_shard_put`` gives one whole
    shard on the mesh's first device (the reference replicates every
    leaf), and the run from it equals the reference's."""
    three = _mesh(3)
    placed = sharding.fleet_shard_put(base["port"], three, N)
    assert isinstance(placed, sharding.SlotShards)
    assert len(placed.shards) == 1 and placed.devices == three.devices[:1]
    assert torch.equal(placed.shards[0].state.member,
                       base["port"].state.member)
    got = fleet.fleet_simulate(placed, TICKS, Settings(), mesh=three,
                               device="cpu")
    _assert_run(got, base["ref"], "D=3")


# ---------------------------------------------------------------------------
# crash, churn and contested members under "hier"
# ---------------------------------------------------------------------------


def _contested(pkg, n: int, seed: int):
    return pkg.AdversarySchedule(n=n, proposes=tuple(
        pkg.ScriptedPropose(slot=i, tick=5, proposal=(0,) if i % 2 else (1,),
                            delay_ticks=4 + i % 3)
        for i in range(n)), seed=seed)


def _dormant_churn_member(settings, port: bool, n: int, c: int):
    """A member whose slots ``[n, c)`` boot dormant and join, then leave,
    on ``synthetic_churn_schedule``'s bursts of 2."""
    uids = [uid_of(e) for e in default_endpoints(c)]
    fp_sum = sum(id_fingerprint(i) for i in default_node_ids(n)) % (1 << 64)
    member = np.arange(c) < n
    sched, id_fps, _ = (churn if port else ref_churn).synthetic_churn_schedule(
        c, n, settings, start=10, burst=2)
    crash = [np.iinfo(np.int32).max] * c
    if port:
        return fleet.FleetMember(
            state=state.init_state(uids, fp_sum, settings, member=member,
                                   id_fps=id_fps, device="cpu"),
            faults=state.link_faults(crash, (), c, device="cpu"),
            churn=fleet._to_device(sched, "cpu"),
            fallback=fleet._to_device(fleet._compile_proposes(
                faults.AdversarySchedule(n=n), None, c), "cpu"))
    return ref_fleet.FleetMember(
        state=ref_state.init_state(uids, fp_sum, settings, member=member,
                                   id_fps=id_fps),
        faults=ref_state.link_faults(crash, (), c), churn=sched,
        fallback=ref_fleet._compile_proposes(
            ref_faults.AdversarySchedule(n=n), None, c))


def _mixed_fleet(settings, port: bool):
    pkg, mod = (faults, fleet) if port else (ref_faults, ref_fleet)
    kw = {"device": "cpu"} if port else {}
    sched, id_fps, _ = (churn if port else ref_churn).synthetic_churn_schedule(
        MIX_C, MIX_N, settings, start=10, burst=2)
    return mod.stack_members([
        mod.lower_schedule(pkg.random_adversary_schedule(MIX_N, 3, MIX_TICKS),
                           settings, **kw),
        mod.lower_schedule(_contested(pkg, MIX_N, 11), settings, **kw),
        mod.lower_schedule(pkg.AdversarySchedule(n=MIX_N, seed=4), settings,
                           churn=sched, id_fps=id_fps, **kw),
        _dormant_churn_member(settings, port, MIX_N, MIX_C)])


def test_mixed_members_on_four_shards_equal_the_reference():
    """Crash, contested and churn members under "hier" with the
    invariant monitor and a 16-row recorder on 4 shards equal the
    reference's fleet; the contested member decides through the classic
    chain, the dormant joiners inject and decide through the fast round
    (the group tally), and no invariant fires."""
    kw = dict(capacity=MIX_C, protocol_variant="hier",
              invariant_checks=True, flight_recorder_window=16)
    settings, ref_settings = Settings(**kw), RefSettings(**kw)
    want = ref_fleet.fleet_simulate(_mixed_fleet(ref_settings, False),
                                    MIX_TICKS, ref_settings)
    got = fleet.fleet_simulate(_mixed_fleet(settings, True), MIX_TICKS,
                               settings, mesh=_mesh(4), device="cpu")
    _assert_run(got, want, "hier on 4 shards")
    logs = to_numpy(got[1])
    assert not logs.inv_bits.any()
    assert logs.decide_now[1].sum() >= 1 and logs.px2b_senders[1].sum() > 0
    assert logs.churn_injected[3].sum() > 0 and logs.decide_now[3].sum() > 1
    assert logs.vote_tally[3].max() > 0


# ---------------------------------------------------------------------------
# F == C: the member axis stays whole
# ---------------------------------------------------------------------------


def _fc_fleet(pkg, mod, settings, port: bool):
    kw = {"device": "cpu"} if port else {}
    schedules = [pkg.random_adversary_schedule(FC, seed=s, ticks=FC_TICKS)
                 for s in range(3)]
    schedules += [_contested(pkg, FC, 20 + j) for j in range(3)]
    return mod.stack_members(
        [mod.lower_schedule(s, settings, **kw) for s in schedules]
        + [_dormant_churn_member(settings, port, FC - 2, FC)] * 2)


def test_f_equal_to_c_keeps_the_member_axis_whole(ref_meshes):
    """Eight members of eight slots under "ring" on eight shards: every
    shard holds all eight members and one slot of each, and the run
    equals the reference's on its own 8-way slot mesh, where
    ``fleet_spec_for`` keeps axis 0 whole."""
    settings = Settings(protocol_variant="ring")
    ref_settings = RefSettings(protocol_variant="ring")
    stacked = _fc_fleet(faults, fleet, settings, True)
    assert tuple(stacked.state.member.shape) == (FC, FC)
    eight = _mesh(8)
    placed = sharding.fleet_shard_put(stacked, eight, FC)
    assert len(placed.shards) == 8
    for shard in placed.shards:
        assert tuple(shard.state.member.shape) == (FC, 1)
        assert tuple(shard.state.reports.shape) == (FC, 1, settings.K)
        assert tuple(shard.state.tick.shape) == (FC,)
    ref_stacked = _fc_fleet(ref_faults, ref_fleet, ref_settings, False)
    want = ref_fleet.fleet_simulate(
        ref_sharding.fleet_shard_put(ref_stacked, ref_meshes[8], FC),
        FC_TICKS, ref_settings, mesh=ref_meshes[8])
    got = fleet.fleet_simulate(placed, FC_TICKS, settings, mesh=eight,
                               device="cpu")
    _assert_run(got, want, "F == C on 8 shards")
    logs = to_numpy(got[1])
    assert logs.decide_now[3:6].sum() >= 3 and logs.decide_now[6:].sum() >= 2


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _named_leaves(member):
    """``{part.field: leaf}`` of a stacked ``FleetMember`` of either
    package (None leaves left out)."""
    out = {}
    for part in ("state", "churn", "fallback"):
        nt = getattr(member, part)
        out.update({f"{part}.{f}": getattr(nt, f) for f in nt._fields})
    out.update({f"faults.{f}": getattr(member.faults, f)
                for f in state.EngineFaults.FIELDS})
    return {k: v for k, v in out.items() if v is not None}


@pytest.mark.parametrize("case", ["base2", "fc8"])
def test_fleet_shard_put_holds_the_reference_placement(ref_meshes, case):
    """Each shard of the port's ``fleet_shard_put`` holds, leaf by leaf,
    what the reference's puts on that device; ``state.join_slots`` gives
    the whole fleet back."""
    if case == "base2":
        n_dev, c = 2, N
        port = _base_fleet(faults, fleet, Settings(), device="cpu")
        ref = _base_fleet(ref_faults, ref_fleet, RefSettings())
    else:
        n_dev, c = 8, FC
        port = _fc_fleet(faults, fleet, Settings(), True)
        ref = _fc_fleet(ref_faults, ref_fleet, RefSettings(), False)
    ref = ref_sharding.fleet_shard_put(ref, ref_meshes[n_dev], c)
    placed = sharding.fleet_shard_put(port, _mesh(n_dev), c)
    assert isinstance(placed, sharding.SlotShards)
    assert placed.devices == _mesh(n_dev).devices and placed.capacity == c
    want = _named_leaves(ref)
    for k, shard in enumerate(placed.shards):
        got = _named_leaves(shard)
        assert got.keys() == want.keys()
        for name, leaf in got.items():
            ref_part = sorted(want[name].addressable_shards,
                              key=lambda sh: sh.device.id)[k].data
            host = np.asarray(leaf)
            assert host.shape == ref_part.shape, (k, name)
            assert np.array_equal(host, np.asarray(ref_part)), (k, name)
    joined = state.join_slots(placed.shards, torch.device("cpu"), fleet=True)
    for name, leaf in _named_leaves(joined).items():
        assert torch.equal(leaf, _named_leaves(port)[name]), name


# ---------------------------------------------------------------------------
# the collectives under vmap
# ---------------------------------------------------------------------------

F_VMAP, PER = 3, 4


def _collectives(g, x, mask, hi, lo, index):
    """Every collective of ``g`` on one member's shard: ``x`` int32 ``[PER,
    2]``, ``mask`` bool ``[PER]``, ``(hi, lo)`` 0-d limbs, ``index`` 0-d."""
    const = torch.tensor(5, dtype=torch.int32)
    return (g.all_gather(x), g.all_gather(x.T, dim=-1),
            g.all_gather(x.T, x.T + 1, dim=1), g.sum(x.sum(), x),
            g.sum(const), g.any(mask.any()), g.max(x.amax()),
            g.min(x.amin(), x[0]), g.sum64(hi, lo), g.first_true(mask),
            g.at(x[:, 0], index))


def _member_inputs(rank: int, n_dev: int):
    gen = torch.Generator().manual_seed(rank)
    x = torch.randint(-50, 50, (F_VMAP, PER, 2), generator=gen,
                      dtype=torch.int32)
    mask = torch.rand(F_VMAP, PER, generator=gen) < 0.3
    mask[0] = False                      # member 0: no slot set anywhere
    hi = torch.randint(0, 2**32, (F_VMAP,), generator=gen)
    lo = torch.randint(0, 2**32, (F_VMAP,), generator=gen)
    index = torch.tensor([0, PER * n_dev // 2, PER * n_dev - 1])
    return x, mask, hi, lo, index


@pytest.mark.parametrize("n_dev", [1, 3])
def test_collectives_under_vmap_equal_per_member_calls(n_dev):
    """Each collective under ``torch.func.vmap`` over F members (and
    under a nested ``vmap`` over members of members) gives every member
    what the same collective called once for that member gives; one
    shard runs them on ``sharding.SOLO``."""
    parts = sharding.SlotShards(tuple(range(n_dev)),
                                (torch.device("cpu"),) * n_dev, PER * n_dev)

    def fn(g, rank):
        args = _member_inputs(rank, n_dev)
        batched = torch.func.vmap(lambda *a: _collectives(g, *a))(*args)
        single = [_collectives(g, *[a[i] for a in args])
                  for i in range(F_VMAP)]
        pairs = tuple(a.expand(2, *a.shape) for a in args)
        nested = torch.func.vmap(torch.func.vmap(
            lambda *a: _collectives(g, *a)))(*pairs)
        return batched, single, nested

    out = sharding.run_spmd(fn, parts, timeout=60)
    for rank, (batched, single, nested) in enumerate(out):
        flat = torch.utils._pytree.tree_leaves(batched)
        nflat = torch.utils._pytree.tree_leaves(nested)
        for i in range(F_VMAP):
            one = torch.utils._pytree.tree_leaves(single[i])
            assert len(one) == len(flat)
            for j, (b, s) in enumerate(zip(flat, one)):
                assert b[i].dtype == s.dtype and torch.equal(b[i], s), \
                    (rank, i, j)
                assert torch.equal(nflat[j][:, i], s.expand(2, *s.shape)), \
                    (rank, i, j)
    # Against the whole: member 1's gather, first set slot and value at a
    # global slot, computed from every shard's inputs at once.
    whole = [_member_inputs(r, n_dev) for r in range(n_dev)]
    x1 = torch.cat([w[0][1] for w in whole])
    m1 = torch.cat([w[1][1] for w in whole])
    for batched, _, _ in out:
        assert torch.equal(batched[0][1], x1)
        assert int(batched[9][1]) == int(torch.argmax(m1.to(torch.uint8)))
        assert int(batched[9][0]) == 0
        assert int(batched[10][1]) == int(x1[PER * n_dev // 2, 0])


def test_a_collective_skipped_under_vmap_names_the_callers_line():
    """Under ``vmap`` the exchange's tag still names the engine's (here
    the test's) line that made the collective."""

    def fn(g, shard):
        xs = torch.ones(2, 3, dtype=torch.int32)
        if g.rank == 0:
            return torch.func.vmap(lambda x: g.sum(x.sum()))(xs)
        return torch.func.vmap(lambda x: g.max(x.max()))(xs)

    parts = sharding.SlotShards((0, 1), (torch.device("cpu"),) * 2, 4)
    with pytest.raises(sharding.ShardError,
                       match=r"test_torch_fleet_slot_mesh\.py:\d+\) met "
                             r"shards \[1\] at another collective"):
        sharding.run_spmd(fn, parts, timeout=30)


def test_a_shard_that_raises_fails_the_fleet(monkeypatch):
    real = step._fleet_step

    def flaky(state_, faults_, settings, host, churn_, fallback, group):
        if group.rank == 1 and host.tick == 3:
            raise RuntimeError("shard 1 failed at tick 4")
        return real(state_, faults_, settings, host, churn_, fallback, group)

    monkeypatch.setattr(step, "_fleet_step", flaky)
    with pytest.raises(sharding.ShardError, match="shard 1 of 2") as info:
        fleet.fleet_simulate(_base_fleet(faults, fleet, Settings(),
                                         device="cpu"), 8, Settings(),
                             mesh=_mesh(2), device="cpu")
    assert isinstance(info.value.__cause__, RuntimeError)
