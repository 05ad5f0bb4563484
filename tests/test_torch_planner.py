"""The port's host churn planner and its oracle mirror against the JAX
reference.

``oracle.membership_view.MembershipView`` after random ``ring_add`` /
``ring_delete`` sequences (rings, observers, subjects, expected
observers, join safety, config ids), ``oracle.cut_detector`` on the same
alert streams, ``oracle.cluster.default_rng``, and ``churn.plan_churn``
on the churn differentials of ``tests/test_engine_diff.py`` (joins,
leaves, mixed crash/join/leave, a partial emission, a join then leave of
one slot, N=256 bursts), the UUID-collision redraw of
``tests/test_topology_static.py``, ``BASELINE.json`` configuration 5's
shape at N=2,000, and the planner's rejections (same exception, same
message, so the same tick). One planned schedule then runs through both
engines, tick by tick. The planners run in this process, so they see the
same salted ``str`` hashes. Tolerance: exact.
"""
import importlib

import numpy as np
import pytest
import torch

from rapid_tpu.engine import churn as ref_churn
from rapid_tpu.engine import diff as ref_diff
from rapid_tpu.engine.state import crash_faults as ref_crash_faults
from rapid_tpu.engine.state import init_state as ref_init_state
from rapid_tpu.oracle import cut_detector as ref_cd
from rapid_tpu.oracle import membership_view as ref_mv
from rapid_tpu.oracle.cluster import default_rng as ref_default_rng
from rapid_tpu.settings import Settings as RefSettings
from rapid_tpu.types import AlertMessage as RefAlert
from rapid_tpu.types import Endpoint as RefEndpoint
from rapid_tpu.types import EdgeStatus as RefStatus
from rapid_tpu.types import NodeId as RefNodeId

from rapid_tpu_torch.convert import from_reference, to_numpy
from rapid_tpu_torch.engine import churn, step
from rapid_tpu_torch.engine.state import I32_MAX, crash_faults, init_state
from rapid_tpu_torch.identity import default_identities
from rapid_tpu_torch.oracle.cluster import default_rng
from rapid_tpu_torch.oracle.cut_detector import MultiNodeCutDetector
from rapid_tpu_torch.oracle.membership_view import MembershipView
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import (AlertMessage, EdgeStatus, Endpoint,
                                   JoinStatusCode, NodeId)

ref_step = importlib.import_module("rapid_tpu.engine.step")
SETTINGS = RefSettings()


def _ep(e):
    return Endpoint(e.hostname, e.port)


def _eps(endpoints):
    return [(e.hostname, e.port) if e is not None else None
            for e in endpoints]


def test_types_print_and_order_like_the_reference():
    ref = ref_diff.default_endpoints(3)
    port = [_ep(e) for e in ref]
    assert [str(e) for e in port] == [str(e) for e in ref]
    assert sorted(port, reverse=True) == [_ep(e) for e in
                                          sorted(ref, reverse=True)]
    ids = [(5, 1), (2, 9), (5, 0)]
    assert sorted(NodeId(*i) for i in ids) == \
        [NodeId(i.high, i.low) for i in sorted(RefNodeId(*i) for i in ids)]
    assert Endpoint.of(("a", 1)) == Endpoint.of(RefEndpoint("a", 1)) == \
        ("a", 1)
    assert NodeId.of((4, 2)) == NodeId.of(RefNodeId(4, 2)) == (4, 2)
    assert [s.name for s in JoinStatusCode] == \
        ["HOSTNAME_ALREADY_IN_RING", "UUID_ALREADY_IN_RING", "SAFE_TO_JOIN",
         "CONFIG_CHANGED", "MEMBERSHIP_REJECTED"]


def test_default_rng_draws_the_reference_ids():
    for e in ref_diff.default_endpoints(20)[::7]:
        a, b = ref_default_rng(SETTINGS, e), default_rng(Settings(), _ep(e))
        assert [a.getrandbits(64) for _ in range(4)] == \
            [b.getrandbits(64) for _ in range(4)]
        assert default_rng(Settings(), (e.hostname, e.port)).getrandbits(
            64) == ref_default_rng(SETTINGS, e).getrandbits(64)


# ---------------------------------------------------------------------------
# the membership view and the cut detector
# ---------------------------------------------------------------------------


def _same_view(port: MembershipView, ref: ref_mv.MembershipView, universe):
    assert port.get_current_configuration_id() == \
        ref.get_current_configuration_id()
    assert port._id_fp_sum == ref._id_fp_sum
    assert port.get_membership_size() == ref.get_membership_size()
    for k in range(ref.K):
        assert _eps(port.get_ring(k)) == _eps(ref.get_ring(k))
    for e in universe:
        pe = _ep(e)
        assert port.is_host_present(pe) == ref.is_host_present(e)
        assert port.ring0_sort_key(pe) == ref.ring0_sort_key(e)
        if ref.is_host_present(e):
            assert _eps(port.get_observers_of(pe)) == \
                _eps(ref.get_observers_of(e))
            assert _eps(port.get_subjects_of(pe)) == \
                _eps(ref.get_subjects_of(e))
        else:
            assert _eps(port.get_expected_observers_of(pe)) == \
                _eps(ref.get_expected_observers_of(e))


@pytest.mark.parametrize("seed,n,k", [(0, 24, 10), (1, 50, 5), (2, 9, 3)])
def test_membership_view_equals_reference_under_random_churn(seed, n, k):
    rng = np.random.default_rng(seed)
    universe = ref_diff.default_endpoints(n + 12)
    ids = ref_diff.default_node_ids(n + 12)
    ref = ref_mv.MembershipView(k, ids[:n], universe[:n])
    port = MembershipView(k, [NodeId(i.high, i.low) for i in ids[:n]],
                          [_ep(e) for e in universe[:n]])
    _same_view(port, ref, universe)
    fresh = n
    for _ in range(30):
        present = [e for e in universe if ref.is_host_present(e)]
        if rng.random() < 0.5 and fresh < len(universe):
            e, node_id = universe[fresh], ids[fresh]
            fresh += 1
            assert port.is_safe_to_join(
                _ep(e), NodeId(node_id.high, node_id.low)).name == \
                ref.is_safe_to_join(e, node_id).name
            ref.ring_add(e, node_id)
            port.ring_add(_ep(e), NodeId(node_id.high, node_id.low))
        elif len(present) > 2:
            e = present[int(rng.integers(len(present)))]
            ref.ring_delete(e)
            port.ring_delete(_ep(e))
        _same_view(port, ref, universe)
    # join safety: a present hostname, a seen identifier, a fresh one
    e = next(e for e in universe if ref.is_host_present(e))
    for ep, node_id in ((e, RefNodeId(1, 7919)), (universe[-1], ids[0]),
                        (universe[-1], RefNodeId(99, 99))):
        assert port.is_safe_to_join(
            _ep(ep), NodeId(node_id.high, node_id.low)).name == \
            ref.is_safe_to_join(ep, node_id).name


def test_membership_view_refusals_match_the_reference():
    ref = ref_mv.MembershipView(3, ref_diff.default_node_ids(4),
                                ref_diff.default_endpoints(4))
    port = MembershipView(3, [NodeId(i + 1, (i + 1) * 7919)
                              for i in range(4)],
                          [Endpoint(f"n{i}.sim", 5000) for i in range(4)])
    for fn, ref_fn, args, ref_args in (
            (port.ring_add, ref.ring_add,
             (Endpoint("x", 1), NodeId(1, 7919)),
             (RefEndpoint("x", 1), RefNodeId(1, 7919))),
            (port.ring_add, ref.ring_add,
             (Endpoint("n0.sim", 5000), NodeId(5, 5)),
             (RefEndpoint("n0.sim", 5000), RefNodeId(5, 5))),
            (port.ring_delete, ref.ring_delete, (Endpoint("x", 1),),
             (RefEndpoint("x", 1),))):
        with pytest.raises(RuntimeError) as got:
            fn(*args)
        with pytest.raises(RuntimeError) as want:
            ref_fn(*ref_args)
        assert type(got.value).__name__ == type(want.value).__name__


def _alerts(view, crashed, status=RefStatus.DOWN):
    """Every observer's DOWN alert about each crashed member, one ring
    each, in (member, ring) order."""
    out = []
    for e in crashed:
        for ring, obs in enumerate(view.get_observers_of(e)):
            out.append(RefAlert(edge_src=obs, edge_dst=e, edge_status=status,
                                configuration_id=0, ring_numbers=(ring,)))
    return out


def _port_alert(a):
    return AlertMessage(edge_src=_ep(a.edge_src), edge_dst=_ep(a.edge_dst),
                        edge_status=EdgeStatus[a.edge_status.name],
                        configuration_id=a.configuration_id,
                        ring_numbers=a.ring_numbers)


@pytest.mark.parametrize("seed", range(4))
def test_cut_detector_emits_what_the_reference_emits(seed):
    rng = np.random.default_rng(seed)
    n = 40
    endpoints = ref_diff.default_endpoints(n)
    ref_view = ref_mv.MembershipView(10, ref_diff.default_node_ids(n),
                                     endpoints)
    port_view = MembershipView(10, [NodeId(i + 1, (i + 1) * 7919)
                                    for i in range(n)],
                               [_ep(e) for e in endpoints])
    crashed = [endpoints[i] for i in rng.choice(n, 3 + seed, replace=False)]
    alerts = _alerts(ref_view, crashed)
    order = rng.permutation(len(alerts))
    ref_det, port_det = ref_cd.MultiNodeCutDetector(10, 9, 4), \
        MultiNodeCutDetector(10, 9, 4)
    for i in order[: len(order) * 3 // 4]:
        want = ref_det.aggregate_for_proposal(alerts[i])
        got = port_det.aggregate_for_proposal(_port_alert(alerts[i]))
        assert _eps(got) == _eps(want)
        assert _eps(port_det.invalidate_failing_edges(port_view)) == \
            _eps(ref_det.invalidate_failing_edges(ref_view))
    assert port_det.get_num_proposals() == ref_det.get_num_proposals()
    port_det.clear()
    assert port_det.get_num_proposals() == 0
    with pytest.raises(ValueError):
        MultiNodeCutDetector(10, 11, 4)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

# (n, capacity, ticks, joins, leaves, crashes)
PLANS = {
    "n64_join_burst": (64, 68, 40, {64: 5, 65: 5, 66: 5, 67: 5}, {}, {}),
    "n64_leave_burst": (64, 64, 40, {}, {3: 5, 17: 5, 40: 5}, {}),
    "n64_mixed_crash_join_leave": (64, 66, 180, {64: 120, 65: 120},
                                   {7: 140}, {3: 5, 17: 5, 40: 5}),
    "n16_join_then_leave_same_slot": (16, 18, 60, {16: 5}, {16: 30}, {}),
    "n256_join_and_leave_bursts": (256, 260, 60,
                                   {s: 5 for s in range(256, 260)},
                                   {11: 30, 42: 30, 197: 30}, {}),
    "n64_uuid_collision_redraw": (64, 65, 40, {64: 5}, {}, {}),
    "n2000_config5_shape": (
        2000, 2032, 200,
        {s: 120 if s < 2016 else 150 for s in range(2000, 2032)},
        {s: 135 if s <= 16 else 165 for s in range(1, 33)},
        {s: 5 for s in range(1000, 1100)}),
}

# The rejections: (n, capacity, ticks, joins, leaves, crashes)
REJECTIONS = {
    "partial_emission": (64, 65, 130, {64: 118}, {}, {4: 5, 9: 5}),
    "overlapping_pipeline": (16, 17, 40, {16: 5}, {3: 9}, {}),
    "view_change_inside_leave_hop": (16, 17, 40, {16: 5}, {3: 10}, {}),
    "leaver_crashing_mid_hop": (16, 16, 40, {}, {3: 5}, {3: 6}),
    "join_slot_not_dormant": (16, 17, 40, {3: 5}, {}, {}),
    "leave_of_a_non_member": (16, 17, 40, {}, {16: 5}, {}),
    "leaver_already_crashed": (16, 16, 40, {}, {3: 5}, {3: 4}),
    "seed_dies_in_phase_1": (16, 17, 40, {16: 5}, {}, {0: 6}),
    "joiner_dies_before_join_messages": (16, 17, 40, {16: 5}, {},
                                         {16: 8}),
}


def _node_ids(name, n, endpoints):
    node_ids = list(ref_diff.default_node_ids(n))
    if name == "n64_uuid_collision_redraw":
        # The joiner's first NodeId draw is burned into member 3, so its
        # join answers UUID_ALREADY_IN_RING and redraws at tick 7.
        rng = ref_default_rng(SETTINGS, endpoints[64])
        node_ids[3] = RefNodeId(rng.getrandbits(64), rng.getrandbits(64))
    return node_ids


def _plans(name, table):
    n, capacity, ticks, joins, leaves, crashes = table[name]
    endpoints = ref_diff.default_endpoints(capacity)
    node_ids = _node_ids(name, n, endpoints)
    ref = lambda: ref_churn.plan_churn(endpoints, n, node_ids, ticks,
                                       SETTINGS, joins=joins, leaves=leaves,
                                       crashes=crashes)
    port = lambda: churn.plan_churn(
        [_ep(e) for e in endpoints], n,
        [NodeId(i.high, i.low) for i in node_ids], ticks, Settings(),
        joins=joins, leaves=leaves, crashes=crashes)
    return ref, port


def _same_plan(got, want):
    for field in ref_churn.ChurnSchedule._fields:
        a, b = getattr(got.schedule, field), getattr(want.schedule, field)
        assert (a is None and b is None) or (
            a.dtype == b.dtype and np.array_equal(a, b)), field
    assert got.id_fps.dtype == np.uint64
    assert np.array_equal(got.id_fps, want.id_fps)
    assert {s: (i.high, i.low) for s, i in got.joiner_ids.items()} == \
        {s: (i.high, i.low) for s, i in want.joiner_ids.items()}
    assert got.wired == want.wired
    assert got.events == want.events
    assert got.final_members == want.final_members
    assert got.final_config_id == want.final_config_id
    assert got.redraws == want.redraws


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_churn_equals_the_reference(name):
    ref, port = _plans(name, PLANS)
    got, want = port(), ref()
    _same_plan(got, want)
    assert any(kind == "view_change" for _, kind, _, _ in got.events)
    assert bool(got.redraws) == (name == "n64_uuid_collision_redraw")
    if name == "n2000_config5_shape":
        assert [(t, len(s)) for t, kind, _, s in got.events
                if kind == "view_change"] == [(113, 100), (126, 16),
                                              (139, 16), (156, 16),
                                              (169, 16)]
        assert len(got.final_members) == 1900


@pytest.mark.parametrize("name", sorted(REJECTIONS))
def test_plan_churn_rejects_as_the_reference_does(name):
    ref, port = _plans(name, REJECTIONS)
    with pytest.raises((ref_churn.ChurnEnvelopeError, ValueError)) as want:
        ref()
    with pytest.raises((churn.ChurnEnvelopeError, ValueError)) as got:
        port()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    if name == "partial_emission":
        assert "partial" in str(got.value)


def test_a_collision_redraw_schedules_the_reference_redraw():
    ref, port = _plans("n64_uuid_collision_redraw", PLANS)
    got = port()
    assert got.redraws == {64: 7} == ref().redraws
    assert got.schedule.redraw_tick[64] == 7


def test_a_planned_schedule_runs_in_both_engines_tick_by_tick():
    """The mixed crash/join/leave plan (both planners, identical) through
    ``init_state(member=, id_fps=)`` and ``simulate(churn=)`` of each
    engine: every log field at every tick and the final state equal, and
    the engine's events equal the plan's."""
    name = "n64_mixed_crash_join_leave"
    n, capacity, ticks, _, _, crashes = PLANS[name]
    ref, port = _plans(name, PLANS)
    want_plan, got_plan = ref(), port()
    uids, _ = default_identities(capacity)
    id_fp_sum = default_identities(n)[1]
    member = np.arange(capacity) < n
    crash = [crashes.get(s, I32_MAX) for s in range(capacity)]
    want_final, want_logs = ref_step.simulate(
        ref_init_state(uids, id_fp_sum, SETTINGS, member=member,
                       id_fps=want_plan.id_fps),
        ref_crash_faults(crash), ticks, SETTINGS,
        churn=want_plan.schedule)
    got_final, got_logs = step.simulate(
        init_state(uids, id_fp_sum, Settings(), member=member,
                   id_fps=got_plan.id_fps, device="cpu"),
        crash_faults(crash, device="cpu"), ticks, Settings(),
        churn=from_reference(got_plan, device="cpu"), device="cpu")
    for got, want in ((got_logs, want_logs), (got_final, want_final)):
        port_np = to_numpy(got)
        for field in want._fields:
            assert np.array_equal(getattr(port_np, field),
                                  np.asarray(getattr(want, field))), field
    decides = [(int(t), tuple(np.nonzero(d)[0].tolist()))
               for t, d in zip(got_logs.tick.numpy(),
                               got_logs.decision.numpy()) if d.any()]
    assert decides == [(t, s) for t, kind, _, s in got_plan.events
                       if kind == "view_change"]
    assert torch.equal(got_final.member,
                       torch.tensor([s in got_plan.final_members
                                     for s in range(capacity)]))
