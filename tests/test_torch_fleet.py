"""The port's shared-engine fleets against the reference's.

A fleet of N=16 members runs 120 ticks through ``fleet.fleet_simulate``
on both sides: two ``random_adversary_schedule`` draws (seeds 3 and 7),
the contested split vote of ``tests/test_fleet.py`` (decided by the
classic chain), a churn member lowered as a campaign lowers it, and a
churn member whose joiners start dormant (built by hand, so joins and
leaves really land). Every member's logs (``[F, T]``), final state and,
with a flight recorder of 16, recorder rings and stamps equal the
reference's exactly, under "rapid", "ring" and "hier" and with the
invariant monitor (``inv_bits`` 0). Lowering and stacking (inert padding
included) equal the reference's leaf by leaf. Against itself: each
member's slice equals its own ``step.simulate`` run, raised padding
changes nothing, and host reads and dispatched aten ops per run do not
depend on F. Everything is integer or bool: the tolerance is exact.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rapid_tpu.engine import churn as ref_churn
from rapid_tpu.engine import fleet as ref_fleet
from rapid_tpu.engine import state as ref_state
from rapid_tpu import faults as ref_faults
from rapid_tpu.engine.diff import default_endpoints, default_node_ids
from rapid_tpu.oracle.membership_view import id_fingerprint, uid_of
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import device, faults
from rapid_tpu_torch.convert import to_numpy
from rapid_tpu_torch.engine import churn, fleet, state, step
from rapid_tpu_torch.settings import Settings

N, TICKS, C = 16, 120, 20


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _contested(pkg):
    return pkg.AdversarySchedule(n=N, proposes=tuple(
        pkg.ScriptedPropose(slot=i, tick=5, proposal=(0,) if i % 2 else (1,),
                            delay_ticks=4 + i % 3)
        for i in range(N)), seed=11)


def _dormant_churn_member(settings, port: bool):
    """A member whose slots ``[N, C)`` boot dormant and join, then leave,
    on ``synthetic_churn_schedule``'s bursts of 2."""
    uids = [uid_of(e) for e in default_endpoints(C)]
    fp_sum = sum(id_fingerprint(i) for i in default_node_ids(N)) % (1 << 64)
    member = np.arange(C) < N
    sched, id_fps, _ = (churn if port else ref_churn).synthetic_churn_schedule(
        C, N, settings, start=10, burst=2)
    crash = [np.iinfo(np.int32).max] * C
    if port:
        return fleet.FleetMember(
            state=state.init_state(uids, fp_sum, settings, member=member,
                                   id_fps=id_fps, device="cpu"),
            faults=state.link_faults(crash, (), C, device="cpu"),
            churn=fleet._to_device(sched, "cpu"),
            fallback=fleet._to_device(fleet._compile_proposes(
                faults.AdversarySchedule(n=N), None, C), "cpu"))
    return ref_fleet.FleetMember(
        state=ref_state.init_state(uids, fp_sum, settings, member=member,
                                   id_fps=id_fps),
        faults=ref_state.link_faults(crash, (), C), churn=sched,
        fallback=ref_fleet._compile_proposes(
            ref_faults.AdversarySchedule(n=N), None, C))


def _members(settings, port: bool):
    pkg, mod = (faults, fleet) if port else (ref_faults, ref_fleet)
    kw = {"device": "cpu"} if port else {}
    scheds = [pkg.random_adversary_schedule(N, 3, TICKS),
              pkg.random_adversary_schedule(N, 7, TICKS), _contested(pkg)]
    members = [mod.lower_schedule(s, settings, **kw) for s in scheds]
    sched, id_fps, _ = (churn if port else ref_churn).synthetic_churn_schedule(
        C, N, settings, start=10, burst=2)
    members.append(mod.lower_schedule(pkg.AdversarySchedule(n=N, seed=4),
                                      settings, churn=sched, id_fps=id_fps,
                                      **kw))
    members.append(_dormant_churn_member(settings, port))
    return members


def _settings(**kw):
    return Settings(capacity=C, **kw), RefSettings(capacity=C, **kw)


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


def _assert_faults_same(port_faults, ref_faults_, what):
    got = to_numpy(port_faults)
    for name in state.EngineFaults.FIELDS:
        want = getattr(ref_faults_, name)
        if want is None or got[name] is None:
            assert want is None and got[name] is None, f"{what}.{name}"
            continue
        assert np.array_equal(got[name], np.asarray(want)), f"{what}.{name}"


def test_lowering_matches_reference():
    settings, ref_settings = _settings()
    for i, (got, want) in enumerate(zip(_members(settings, True),
                                        _members(ref_settings, False))):
        _assert_same(got.state, want.state, f"member {i} state")
        _assert_faults_same(got.faults, want.faults, f"member {i} faults")
        _assert_same(got.churn, want.churn, f"member {i} churn")
        _assert_same(got.fallback, want.fallback, f"member {i} fallback")


@pytest.mark.parametrize("maxima", [{}, {"n_windows": 3, "n_instances": 2,
                                         "n_pids": 4}])
def test_stacking_matches_reference(maxima):
    settings, ref_settings = _settings()
    got = fleet.stack_members(_members(settings, True), **maxima)
    want = ref_fleet.stack_members(_members(ref_settings, False), **maxima)
    _assert_same(got.state, want.state, "state")
    _assert_faults_same(got.faults, want.faults, "faults")
    _assert_same(got.churn, want.churn, "churn")
    _assert_same(got.fallback, want.fallback, "fallback")


@pytest.mark.parametrize("options", [
    {"flight_recorder_window": 16},
    {"invariant_checks": True},
    {"protocol_variant": "ring"},
    {"protocol_variant": "hier"},
], ids=["recorder16", "invariants", "ring", "hier"])
def test_fleet_matches_reference(options):
    settings, ref_settings = _settings(**options)
    got = fleet.fleet_simulate(fleet.stack_members(_members(settings, True)),
                               TICKS, settings, device="cpu")
    want = ref_fleet.fleet_simulate(
        ref_fleet.stack_members(_members(ref_settings, False)), TICKS,
        ref_settings)
    _assert_same(got[1], want[1], "logs")
    _assert_same(got[0], want[0], "finals")
    if settings.flight_recorder_window:
        _assert_same(got[2], want[2], "recorders")
    logs = to_numpy(got[1])
    assert not logs.inv_bits.any()
    # The contested member decides through the classic chain, and the
    # dormant joiners really join.
    assert logs.decide_now[2].sum() >= 1 and logs.px2b_senders[2].sum() > 0
    assert logs.churn_injected[4].sum() > 0 and logs.decide_now[4].sum() > 0


def _simulate_member(member, settings):
    return step.simulate(member.state, member.faults, TICKS, settings,
                         churn=member.churn, fallback=member.fallback,
                         device="cpu")


def test_member_slice_equals_its_unbatched_run():
    settings, _ = _settings(flight_recorder_window=16, invariant_checks=True)
    stacked = fleet.stack_members(_members(settings, True))
    finals, logs, recs = fleet.fleet_simulate(stacked, TICKS, settings,
                                              device="cpu")
    for i in range(stacked.state.member.shape[0]):
        one = _simulate_member(fleet.member_of(stacked, i), settings)
        for got, want in zip((fleet.member_of(finals, i),
                              fleet.member_logs(logs, i),
                              fleet.member_of(recs, i)), one):
            for name, a, b in zip(want._fields, got, want):
                assert torch.equal(a, b), f"member {i} {name}"


def test_inert_padding_changes_nothing():
    settings, _ = _settings()
    members = _members(settings, True)
    tight = fleet.fleet_simulate(fleet.stack_members(members), TICKS,
                                 settings, device="cpu")
    padded = fleet.fleet_simulate(
        fleet.stack_members(members, n_windows=4, n_instances=3, n_pids=5),
        TICKS, settings, device="cpu")
    for name, a, b in zip(tight[1]._fields, tight[1], padded[1]):
        assert torch.equal(a, b), name
    for name in ("member", "epoch", "memsum_hi", "memsum_lo", "reports"):
        assert torch.equal(getattr(tight[0], name), getattr(padded[0], name))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def _run_counted(members, settings, ticks):
    stacked = fleet.stack_members(members)
    device.host_reads = 0
    with _CountOps() as counter:
        fleet.fleet_simulate(stacked, ticks, settings, device="cpu")
    return device.host_reads, counter.ops


def test_host_reads_and_ops_do_not_grow_with_f():
    """The batched tick's host reads and dispatched aten ops per run are
    the same at F=2 and F=8 on the same scenarios (each repeated)."""
    settings, _ = _settings(invariant_checks=True)
    members = _members(settings, True)
    pair = [members[2], members[4]]
    small = _run_counted(pair, settings, 40)
    large = _run_counted(pair * 4, settings, 40)
    assert small == large
    assert small[0] <= 2 * 40 + 1


def test_refusals():
    settings, _ = _settings()
    rule = faults.DelayRule(src_slots=frozenset({0}),
                            dst_slots=frozenset({1}))
    with pytest.raises(ValueError, match="delay rules"):
        fleet.lower_schedule(faults.AdversarySchedule(n=N, delays=(rule,)),
                             settings, device="cpu")
    members = _members(settings, True)
    other = fleet.lower_schedule(faults.AdversarySchedule(n=24), settings,
                                 device="cpu")
    with pytest.raises(ValueError, match="one capacity"):
        fleet.stack_members([members[0], other])
    redraw = members[0].churn._replace(
        redraw_tick=torch.zeros(C, dtype=torch.int32))
    with pytest.raises(ValueError, match="redraw"):
        fleet.stack_members([members[0]._replace(churn=redraw)])
    with pytest.raises(ValueError, match="redraw"):
        fleet.lower_schedule(faults.AdversarySchedule(n=N), settings,
                             churn=redraw, device="cpu")
    with pytest.raises(ValueError, match="below the fleet max"):
        fleet.stack_members(members, n_pids=1)
    with pytest.raises(ValueError, match="cannot shrink"):
        fleet._pad_fallback(members[2].fallback, 1, 1)
    with pytest.raises(ValueError, match="cannot shrink"):
        state.pad_link_windows(members[0].faults, 0)
    dropped = members[1]._replace(faults=state.EngineFaults(
        drop_p=0.1, **{f: getattr(members[1].faults, f)
                       for f in state.EngineFaults.FIELDS}))
    with pytest.raises(ValueError, match="probe-drop"):
        fleet.stack_members([members[1], dropped])
    stacked = fleet.stack_members(members[:2])
    for kw in ({"mesh": object()}, {"fleet_mesh": object()}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            fleet.fleet_simulate(stacked, 4, settings, device="cpu", **kw)


@pytest.mark.parametrize("entry", ["lower_schedule", "fleet_simulate",
                                   "lower_receiver_schedule",
                                   "receiver_fleet_simulate"])
def test_fleet_entry_points_default_to_the_card(entry, monkeypatch):
    from rapid_tpu_torch.device import NoCudaDeviceError

    settings, _ = _settings()
    rx = Settings(rx_kernel="pallas")
    sched = faults.AdversarySchedule(n=N)
    calls = {
        "lower_schedule": lambda: fleet.lower_schedule(sched, settings),
        "fleet_simulate": lambda: fleet.fleet_simulate(
            fleet.stack_members(_members(settings, True)[:1]), 2, settings),
        "lower_receiver_schedule": lambda: fleet.lower_receiver_schedule(
            sched, rx),
        "receiver_fleet_simulate": lambda: fleet.receiver_fleet_simulate(
            fleet.stack_receiver_members([fleet.lower_receiver_schedule(
                sched, rx, device="cpu")]), 2, rx),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        calls[entry]()


def test_from_reference_carries_a_stacked_fleet():
    """``convert.from_reference`` takes the reference's stacked
    ``FleetMember``: the same leaves as the port's own stack, and the
    same run from them."""
    from rapid_tpu_torch.convert import from_reference

    settings, ref_settings = _settings(flight_recorder_window=16)
    want_fleet = ref_fleet.stack_members(_members(ref_settings, False))
    carried = from_reference(want_fleet, device="cpu")
    own = fleet.stack_members(_members(settings, True))
    for part in ("state", "churn", "fallback"):
        _assert_same(getattr(carried, part), getattr(want_fleet, part), part)
        _assert_same(getattr(own, part), getattr(want_fleet, part), part)
    got = fleet.fleet_simulate(carried, 40, settings, device="cpu")
    want = ref_fleet.fleet_simulate(want_fleet, 40, ref_settings)
    for g, w, what in zip(got, want, ("finals", "logs", "recorders")):
        _assert_same(g, w, what)
