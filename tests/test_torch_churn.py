"""The port's churn (join/leave alert schedules, identifier redraws)
against the JAX reference: ``topology.rank_and_insert``,
``cut.deliver_churn_reports``, ``churn.apply_redraws`` and
``synthetic_churn_schedule`` as parts, then whole runs of
``step.simulate(..., churn=)`` with schedules from the reference's
planner — every ``StepLog`` field at every tick and every final-state
field. Everything is integer or bool: the tolerance is exact."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_tpu import hashing as ref_hashing
from rapid_tpu.engine import churn as ref_churn
from rapid_tpu.engine import cut as ref_cut
from rapid_tpu.engine import diff as ref_diff
from rapid_tpu.engine import topology as ref_topology
from rapid_tpu.engine.churn import plan_churn
from rapid_tpu.engine.state import crash_faults as ref_crash_faults
from rapid_tpu.engine.state import init_state as ref_init_state
from rapid_tpu.oracle.cluster import default_rng
from rapid_tpu.oracle.membership_view import MembershipView, uid_of
from rapid_tpu.settings import Settings as RefSettings
from rapid_tpu.types import NodeId

from rapid_tpu_torch import device
from rapid_tpu_torch.convert import from_reference, to_numpy
from rapid_tpu_torch.engine import churn, cut, diff, step, topology
from rapid_tpu_torch.engine.state import I32_MAX
from rapid_tpu_torch.settings import Settings

ref_step = importlib.import_module("rapid_tpu.engine.step")
SETTINGS = RefSettings()


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _assert_same(port_nt, ref_nt):
    port_np = to_numpy(port_nt)
    for name in ref_nt._fields:
        want = np.asarray(getattr(ref_nt, name))
        got = getattr(port_np, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if not np.array_equal(got, want):
            first = (np.argwhere(got != want)[0].tolist()
                     if got.ndim else [])
            pytest.fail(f"{name} differs first at {first}")


def _limbs(c, seed):
    """Distinct uid limbs, as ``tests/test_topology_static.py`` makes them."""
    hi, lo = ref_hashing.np_to_limbs(np.arange(1, c + 1, dtype=np.uint64))
    return ref_hashing.hash64_limbs(np, hi, lo, seed=0xABC0 ^ seed)


# ---------------------------------------------------------------------------
# parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,c,k", [(0, 41, 5), (3, 41, 5), (9, 23, 4),
                                      (11, 200, 10)])
def test_rank_and_insert_equals_reference(seed, c, k):
    uid_hi, uid_lo = _limbs(c, seed)
    order, rank = ref_topology.ring_permutations(np, uid_hi, uid_lo, k)
    port_order, port_rank = torch.from_numpy(order), torch.from_numpy(rank)
    rng = np.random.default_rng(seed + 100)
    # First and last slots, then random ones, each with a fresh identity.
    for slot in [0, c - 1] + rng.integers(c, size=4).tolist():
        uid_hi[slot] = np.uint32(rng.integers(1 << 32))
        uid_lo[slot] = np.uint32(rng.integers(1 << 32))
        order, rank = ref_topology.rank_and_insert(np, slot, uid_hi, uid_lo,
                                                   order, rank)
        port_order, port_rank = topology.rank_and_insert(
            slot, _t(uid_hi), _t(uid_lo), port_order, port_rank)
        assert port_order.dtype == torch.int32
        assert np.array_equal(port_order.numpy(), order)
        assert np.array_equal(port_rank.numpy(), rank)
    # ... and the incremental result is the from-scratch sort.
    assert np.array_equal(
        port_order.numpy(),
        ref_topology.ring_permutations(np, uid_hi, uid_lo, k)[0])


def test_rank_and_insert_keeps_an_unmoved_slot():
    uid_hi, uid_lo = _limbs(17, 5)
    order, rank = ref_topology.ring_permutations(np, uid_hi, uid_lo, 3)
    got = topology.rank_and_insert(7, _t(uid_hi), _t(uid_lo),
                                   torch.from_numpy(order),
                                   torch.from_numpy(rank))
    assert np.array_equal(got[0].numpy(), order)
    assert np.array_equal(got[1].numpy(), rank)


def _join_burst_plan(n=64, capacity=68, ticks=40):
    endpoints = ref_diff.default_endpoints(capacity)
    node_ids = ref_diff.default_node_ids(n)
    plan = plan_churn(endpoints, n, node_ids, ticks, SETTINGS,
                      joins={s: 5 for s in range(n, capacity)})
    uids = [uid_of(e) for e in endpoints]
    id_fp_sum = MembershipView(SETTINGS.K, node_ids, [])._id_fp_sum
    state = ref_init_state(uids, id_fp_sum, SETTINGS,
                           member=[True] * n + [False] * (capacity - n),
                           id_fps=plan.id_fps)
    return plan, state


def _ref_steps(state, faults, ticks, churn_sched=None, fallback=None):
    """The reference's states after each of ``ticks`` single jitted steps."""
    states = []
    for _ in range(ticks):
        state, _ = ref_step.engine_step(state, faults, SETTINGS, churn_sched,
                                        fallback)
        states.append(state)
    return states


@pytest.fixture(scope="module")
def join_burst_states():
    plan, state = _join_burst_plan()
    faults = ref_crash_faults([I32_MAX] * 68)
    return plan, _ref_steps(state, faults, 12, plan.schedule)


@pytest.mark.parametrize("after_tick", [7, 9, 10])
def test_deliver_churn_reports_equals_reference(join_burst_states,
                                                after_tick):
    """After tick 9 the burst's joins are in ``churn_deliver`` (the
    injection was at 8); before and after that nothing is."""
    _, states = join_burst_states
    state = states[after_tick - 1]
    port = from_reference(state, device="cpu")
    rng = np.random.default_rng(after_tick)
    for alive in (np.ones(68, bool), rng.random(68) < 0.7):
        want = ref_cut.deliver_churn_reports(jnp, state, jnp.asarray(alive))
        got = cut.deliver_churn_reports(port, torch.from_numpy(alive))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    up = np.asarray(ref_cut.deliver_churn_reports(
        jnp, state, jnp.ones(68, bool))[1])
    assert up.any() == (after_tick == 9)


def test_inject_equals_the_reference_phase(join_burst_states):
    plan, states = join_burst_states
    sched = from_reference(plan.schedule, device="cpu")
    state = from_reference(states[6], device="cpu")   # after tick 7
    flush, injected = churn.inject(state, sched, 8)
    assert int(injected) == 4
    assert np.array_equal(flush.numpy(), np.arange(68) >= 64)
    # The next tick's state (reference) carries exactly that flush.
    assert np.array_equal(np.asarray(states[7].churn_flush), flush.numpy())
    # A stale epoch expectation expires the alerts.
    stale = state._replace(epoch=state.epoch + 1)
    assert int(churn.inject(stale, sched, 8)[1]) == 0


def _redraw_scenario():
    """The scenario of ``tests/test_topology_static.py``'s scheduled
    redraw: dormant slot 12 of 13 redraws at tick 3."""
    n, c, slot = 12, 13, 12
    hi, lo = _limbs(c, 4)
    uids = ref_hashing.np_from_limbs(hi, lo)
    state = ref_init_state(uids, 0, SETTINGS, member=[True] * n + [False])
    new_hi, new_lo = ref_hashing.to_limbs(ref_hashing.hash64(0x5EED,
                                                             seed=7))
    sched = ref_churn.empty_schedule(c)
    redraw_tick = np.full(c, I32_MAX, np.int32)
    redraw_tick[slot] = 3
    zeros = np.zeros(c, np.uint32)
    sched = sched._replace(
        redraw_tick=redraw_tick, redraw_hi=zeros.copy(),
        redraw_lo=zeros.copy(), redraw_idfp_hi=zeros.copy(),
        redraw_idfp_lo=zeros.copy())
    sched.redraw_hi[slot] = new_hi
    sched.redraw_lo[slot] = new_lo
    sched.redraw_idfp_hi[slot] = 0x1234
    sched.redraw_idfp_lo[slot] = 0x5678
    return state, sched


def test_apply_redraws_equals_reference():
    state, sched = _redraw_scenario()
    want = ref_churn.apply_redraws(
        jnp, state, type(sched)(*[jnp.asarray(x) for x in sched]), 3)
    got = churn.apply_redraws(from_reference(state, device="cpu"),
                              from_reference(sched, device="cpu"), 12)
    _assert_same(got, want)
    assert int(got.uid_hi[12]) != int(np.asarray(state.uid_hi)[12])


def test_synthetic_churn_schedule_equals_reference():
    for c, n, burst, period in ((1096, 1000, 8, 6), (70, 64, 2, None),
                                (100_096, 100_000, 8, 6)):
        want = ref_churn.synthetic_churn_schedule(
            c, n, SETTINGS, start=10, burst=burst, period=period)
        got = churn.synthetic_churn_schedule(c, n, Settings(), start=10,
                                             burst=burst, period=period)
        for field in ref_churn.ChurnSchedule._fields:
            a, b = getattr(got[0], field), getattr(want[0], field)
            assert (a is None and b is None) or (
                a.dtype == b.dtype and np.array_equal(a, b)), field
        assert got[1].dtype == np.uint64
        assert np.array_equal(got[1], want[1])
        assert got[2] == want[2]
    with pytest.raises(ValueError, match="period"):
        churn.synthetic_churn_schedule(70, 64, Settings(), period=3)


def test_empty_schedule_equals_reference():
    got, want = churn.empty_schedule(9), ref_churn.empty_schedule(9)
    for field in ("join_tick", "join_epoch", "leave_tick", "leave_epoch"):
        assert np.array_equal(getattr(got, field), getattr(want, field))
    assert got.redraw_tick is None and want.redraw_tick is None


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

# (n, capacity, ticks, joins, leaves, crashes, node_ids override) — the
# churn differentials of tests/test_engine_diff.py, and the UUID-collision
# redraw of tests/test_topology_static.py.
RUNS = {
    "n64_join_burst": (64, 68, 40, {64: 5, 65: 5, 66: 5, 67: 5}, {}, {}),
    "n64_leave_burst": (64, 64, 40, {}, {3: 5, 17: 5, 40: 5}, {}),
    "n64_mixed_crash_join_leave": (64, 66, 180, {64: 120, 65: 120},
                                   {7: 140}, {3: 5, 17: 5, 40: 5}),
    "n16_join_then_leave_same_slot": (16, 18, 60, {16: 5}, {16: 30}, {}),
    "n256_join_and_leave_bursts": (256, 260, 60,
                                   {s: 5 for s in range(256, 260)},
                                   {11: 30, 42: 30, 197: 30}, {}),
    "n64_uuid_collision_redraw": (64, 65, 40, {64: 5}, {}, {}),
}

DECIDES = {
    "n64_join_burst": [(11, (64, 65, 66, 67))],
    "n64_leave_burst": [(9, (3, 17, 40))],
    "n64_mixed_crash_join_leave": [(113, (3, 17, 40)), (126, (64, 65)),
                                   (144, (7,))],
    "n16_join_then_leave_same_slot": [(11, (16,)), (34, (16,))],
    "n256_join_and_leave_bursts": [(11, (256, 257, 258, 259)),
                                   (34, (11, 42, 197))],
    "n64_uuid_collision_redraw": [(13, (64,))],
}


def _boot(name):
    n, capacity, ticks, joins, leaves, crashes = RUNS[name]
    endpoints = ref_diff.default_endpoints(capacity)
    node_ids = list(ref_diff.default_node_ids(n))
    if name == "n64_uuid_collision_redraw":
        # The joiner's first NodeId draw is burned into member 3, so its
        # join answers UUID_ALREADY_IN_RING and redraws at tick 7.
        rng = default_rng(SETTINGS, endpoints[64])
        node_ids[3] = NodeId(rng.getrandbits(64), rng.getrandbits(64))
    plan = plan_churn(endpoints, n, node_ids, ticks, SETTINGS, joins=joins,
                      leaves=leaves, crashes=crashes)
    uids = [uid_of(e) for e in endpoints]
    id_fp_sum = MembershipView(SETTINGS.K, node_ids, [])._id_fp_sum
    state = ref_init_state(uids, id_fp_sum, SETTINGS,
                           member=[True] * n + [False] * (capacity - n),
                           id_fps=plan.id_fps)
    faults = ref_crash_faults([crashes.get(s, I32_MAX)
                               for s in range(capacity)])
    return plan, state, faults, ticks


def _port_run(state, faults, ticks, churn_sched):
    before = device.host_reads
    got = step.simulate(
        from_reference(state, device="cpu"),
        from_reference(faults, device="cpu"), ticks, Settings(),
        churn=from_reference(churn_sched, device="cpu"), device="cpu")
    return got, device.host_reads - before


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request):
    plan, state, faults, ticks = _boot(request.param)
    want = ref_step.simulate(state, faults, ticks, SETTINGS,
                             churn=plan.schedule)
    got, reads = _port_run(state, faults, ticks, plan.schedule)
    return request.param, plan, want, got, reads


def test_churn_logs_equal_the_reference_at_every_tick(runs):
    _, _, (_, ref_logs), (_, port_logs), _ = runs
    _assert_same(port_logs, ref_logs)


def test_churn_final_state_equals_the_reference(runs):
    _, _, (ref_final, _), (port_final, _), _ = runs
    _assert_same(port_final, ref_final)


def test_churn_events_and_counters_equal_the_reference(runs):
    name, plan, (_, ref_logs), (_, port_logs), _ = runs
    events = [e.as_dict() for e in diff.engine_events(port_logs)]
    assert events == [e.as_dict() for e in ref_diff.engine_events(ref_logs)]
    assert diff.expand_counters(port_logs) == \
        ref_diff.expand_counters(ref_logs)
    decides = [(e["tick"], tuple(e["slots"])) for e in events
               if e["kind"] == "view_change"]
    assert decides == DECIDES[name]
    assert int(port_logs.churn_injected.sum()) > 0
    assert (name == "n64_uuid_collision_redraw") == bool(plan.redraws)


def test_churn_adds_no_host_read_per_tick(runs):
    """One read at start (tick, epoch and the schedule in one transfer),
    one for the first tick's vote-arrival bit, then the announce read
    every tick and the decide read on vote ticks; a redraw tick reads
    whether its slot is dormant."""
    name, plan, (_, ref_logs), _, reads = runs
    ticks = len(np.asarray(ref_logs.tick))
    vote_ticks = int((np.asarray(ref_logs.quorum) > 0).sum())
    assert reads == 2 + ticks + vote_ticks + len(plan.redraws)


@pytest.mark.parametrize("split", [7, 8, 9, 10, 12])
def test_churn_run_resumed_mid_pipeline_equals_reference(split):
    """The port resumed from the reference's state at ``split`` (around
    the join burst's injection at 8, flush at 9, delivery at 10 and
    decide at 11) ends where the reference's whole run does."""
    plan, state, faults, ticks = _boot("n64_join_burst")
    head, _ = ref_step.simulate(state, faults, split, SETTINGS,
                                churn=plan.schedule)
    want, want_logs = ref_step.simulate(state, faults, ticks, SETTINGS,
                                        churn=plan.schedule)
    (got, got_logs), _ = _port_run(head, faults, ticks - split,
                                   plan.schedule)
    _assert_same(got, want)
    for field in ("decide_now", "churn_injected", "alerts_in_flight"):
        assert np.array_equal(getattr(got_logs, field).numpy(),
                              np.asarray(getattr(want_logs, field))[split:])


def test_scheduled_redraw_run_equals_reference():
    """Dormant slot 12 redraws at tick 3 with no join: its ring arrays,
    identity limbs and fingerprints move, every tick logs the same."""
    state, sched = _redraw_scenario()
    faults = ref_crash_faults([I32_MAX] * 13)
    want = ref_step.simulate(state, faults, 6, SETTINGS, churn=sched)
    (got, got_logs), reads = _port_run(state, faults, 6, sched)
    _assert_same(got, want[0])
    _assert_same(got_logs, want[1])
    assert reads == 2 + 6 + 1
    assert not np.array_equal(got.ring_order.numpy(),
                              np.asarray(state.ring_order))


def test_simulate_reads_once_per_redraw_tick():
    """Each of the schedule's redraw ticks reads once whether a dormant
    slot redraws and which: dormant slot 12 at tick 3, and member slot 5
    at tick 5, which does not redraw; the other ticks read nothing more,
    and the run equals the reference's."""
    state, sched = _redraw_scenario()
    sched.redraw_tick[5] = 5
    faults = ref_crash_faults([I32_MAX] * 13)
    want = ref_step.simulate(state, faults, 8, SETTINGS, churn=sched)
    (got, got_logs), reads = _port_run(state, faults, 8, sched)
    _assert_same(got, want[0])
    _assert_same(got_logs, want[1])
    assert reads == 2 + 8 + 2


def test_simulate_refuses_a_schedule_on_another_device():
    plan, state, faults, _ = _boot("n64_leave_burst")
    sched = from_reference(plan.schedule, device="cpu")
    with pytest.raises(ValueError, match="churn schedule lives on meta"):
        step.simulate(from_reference(state, device="cpu"),
                      from_reference(faults, device="cpu"), 2, Settings(),
                      churn=sched._replace(
                          join_tick=sched.join_tick.to("meta")),
                      device="cpu")
