"""The port's per-receiver fleets and the member axis of ``rx_deliver``.

A fleet of N=16 members (``sample_adversary_schedule`` with only the
partition and flip-flop kinds, seeds 2, 5 and 9, and one jitter member,
as ``tests/test_receiver.py`` stacks them) runs 80 ticks on both sides:
the reference on its dense carry (``rx_kernel="xla"``, its default), the
port on the packed carry. Every member's logs and its final ``member``,
``stopped``, config ids and flags (``receiver_final_view``) equal the
reference's exactly, and no envelope flag is set. Lowering and stacking
equal the reference's packed bundles leaf by leaf. Against itself: each
member's slice equals its own ``receiver_simulate`` run (recorder
included); a tick delivers six times and dispatches the same aten ops
whatever F is. ``account_into_plain`` over ``[F, B, C, C]`` equals F
calls of one member, counter row by counter row. ``ReceiverBudgetError``
carries the reference's attributes and message.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rapid_tpu import faults as ref_faults
from rapid_tpu.engine import fleet as ref_fleet
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import faults
from rapid_tpu_torch.convert import from_reference, to_numpy
from rapid_tpu_torch.engine import fleet, receiver, rx_account, sharding
from rapid_tpu_torch.settings import Settings

N, TICKS = 16, 80
SETTINGS = Settings(rx_kernel="pallas")


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _schedules(pkg):
    only = lambda *kinds: pkg.ScenarioWeights(
        **{k: (1.0 if k in kinds else 0.0) for k in pkg.SCENARIO_KINDS})
    out = [pkg.sample_adversary_schedule(
        N, s, TICKS, only("partition", "flip_flop")).schedule
        for s in (2, 5, 9)]
    out.append(pkg.sample_adversary_schedule(N, 4, TICKS, only("jitter"),
                                             ring_depth=4).schedule)
    return out


def _members(settings=SETTINGS):
    return [fleet.lower_receiver_schedule(s, settings, device="cpu")
            for s in _schedules(faults)]


def _assert_same(port_nt, ref_nt, what, fields=None):
    port_np = to_numpy(port_nt)
    for name in fields or ref_nt._fields:
        want = np.asarray(getattr(ref_nt, name))
        got = np.asarray(getattr(port_np, name))
        assert got.dtype == want.dtype and got.shape == want.shape, \
            f"{what}.{name}"
        assert np.array_equal(got, want), f"{what}.{name}"


def test_receiver_fleet_matches_reference():
    ref_settings = RefSettings()
    want_finals, want_logs = ref_fleet.receiver_fleet_simulate(
        ref_fleet.stack_receiver_members(
            [ref_fleet.lower_receiver_schedule(s, ref_settings)
             for s in _schedules(ref_faults)]), TICKS, ref_settings)
    finals, logs = fleet.receiver_fleet_simulate(
        fleet.stack_receiver_members(_members()), TICKS, SETTINGS,
        device="cpu")
    _assert_same(logs, want_logs, "logs")
    view = receiver.receiver_final_view(finals)
    _assert_same(view, want_finals, "finals", view._fields)
    for flags in view.flags:
        receiver.check_flags(flags)


@pytest.mark.parametrize("maxima", [{}, {"n_windows": 2,
                                         "n_delay_rules": 3}])
def test_receiver_stacking_matches_reference(maxima):
    ref_settings = RefSettings(rx_kernel="pallas")
    want = ref_fleet.stack_receiver_members(
        [ref_fleet.lower_receiver_schedule(s, ref_settings)
         for s in _schedules(ref_faults)], **maxima)
    got = fleet.stack_receiver_members(_members(), **maxima)
    _assert_same(got.state.packed, want.state.packed, "packed")
    carried = from_reference(want, device="cpu")
    _assert_same(carried.state.packed, want.state.packed, "carried")
    assert all(torch.equal(getattr(carried.faults, f), getattr(got.faults, f))
               for f in fleet.EngineFaults.FIELDS
               if getattr(got.faults, f) is not None)
    assert np.array_equal(got.state.delay_table.numpy(),
                          np.asarray(want.state.delay_table))
    got_faults = to_numpy(got.faults)
    for name, value in got_faults.items():
        ref_value = getattr(want.faults, name)
        if value is None or ref_value is None:
            assert value is None and ref_value is None, name
        else:
            assert np.array_equal(value, np.asarray(ref_value)), name


def test_member_slice_equals_its_unbatched_run():
    settings = SETTINGS.with_(flight_recorder_window=16)
    stacked = fleet.stack_receiver_members(_members(settings))
    finals, logs, recs = fleet.receiver_fleet_simulate(stacked, TICKS,
                                                       settings,
                                                       device="cpu")
    view = receiver.receiver_final_view(finals)
    for i in range(len(view.flags)):
        m = fleet.member_of(stacked, i)
        final, one_logs, rec = receiver.receiver_simulate(
            m.state, m.faults, TICKS, settings)
        for name in one_logs._fields:
            assert torch.equal(getattr(one_logs, name),
                               getattr(logs, name)[i]), name
        for name in view._fields:
            assert torch.equal(getattr(final, name),
                               getattr(view, name)[i]), name
        for name in rec._fields:
            assert torch.equal(getattr(rec, name),
                               getattr(recs, name)[i]), name


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def test_deliveries_and_ops_do_not_grow_with_f(monkeypatch):
    calls = []
    plain = rx_account.account_into

    def spy(msgs, *args):
        calls.append(tuple(msgs.shape))
        return plain(msgs, *args)

    monkeypatch.setattr(rx_account, "account_into", spy)
    members = _members()[:2]
    ops = []
    for fleet_members in (members, members * 4):
        stacked = fleet.stack_receiver_members(fleet_members)
        calls.clear()
        with _Count() as counter:
            fleet.receiver_fleet_simulate(stacked, 6, SETTINGS,
                                          device="cpu")
        assert len(calls) == 6 * 6
        assert all(shape[0] == len(fleet_members) for shape in calls)
        ops.append(counter.ops)
    assert ops[0] == ops[1]


@pytest.mark.parametrize("c", [13, 32, 48])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("f", [1, 3])
def test_plain_delivery_over_members(f, b, c):
    from rapid_tpu_torch.engine.rx_packed import pack_bits

    rng = np.random.default_rng(100 * f + 10 * b + c)
    shape = (f, c, c) if b == 1 else (f, b, c, c)
    msgs = torch.from_numpy(rng.random(shape) < 0.4)
    crashed = torch.from_numpy(rng.random((f, c)) < 0.2)
    pemat = pack_bits(torch.from_numpy(rng.random((f, c, c)) < 0.3))
    start = torch.from_numpy(rng.integers(0, 50, (f, 14)).astype(np.int32))
    for phase in (None, 5):
        acc = start.clone()
        deliv = rx_account.account_into_plain(msgs, crashed, pemat, acc,
                                              phase)
        for i in range(f):
            one = start[i].clone()
            want = rx_account.account_into_plain(msgs[i], crashed[i],
                                                 pemat[i], one, phase)
            assert torch.equal(deliv[i], want)
            assert torch.equal(acc[i], one)


@pytest.mark.parametrize("capacity, cap", [(1040, 1024), (4112, 4096)])
@pytest.mark.parametrize("fleet_size", [1, 256])
@pytest.mark.parametrize("rx_kernel", ["pallas", "xla"])
def test_budget_error_matches_reference(capacity, cap, fleet_size,
                                        rx_kernel):
    """The byte figures come from the port's own layouts (meta tensors
    through ``pack_receiver_state``), counted with the reference's 32-bit
    limbs: they equal the reference's, field by field and in the
    message."""
    from rapid_tpu.engine import rx_packed as ref_rx_packed

    settings = Settings(rx_kernel=rx_kernel, receiver_capacity_cap=cap)
    ref_settings = RefSettings(rx_kernel=rx_kernel,
                               receiver_capacity_cap=cap)
    with pytest.raises(ref_fleet.ReceiverBudgetError) as want:
        ref_fleet.check_receiver_budget(capacity, fleet_size, ref_settings)
    with pytest.raises(fleet.ReceiverBudgetError) as got:
        fleet.check_receiver_budget(capacity, fleet_size, settings)
    for name in ("capacity", "fleet_size", "cap", "member_bytes",
                 "total_bytes", "packed_bytes", "unpacked_bytes"):
        assert getattr(got.value, name) == getattr(want.value, name), name
    assert str(got.value) == str(want.value)
    assert got.value.packed_bytes == ref_rx_packed.bundle_state_bytes(
        capacity, ref_settings)
    assert got.value.unpacked_bytes == ref_rx_packed.dense_state_bytes(
        capacity, ref_settings)
    assert isinstance(got.value, ValueError)


def test_receiver_refusals():
    sched = faults.AdversarySchedule(n=16, proposes=(faults.ScriptedPropose(
        slot=0, tick=5, proposal=(1,), delay_ticks=3),))
    with pytest.raises(ValueError, match="scripted"):
        fleet.lower_receiver_schedule(sched, SETTINGS, device="cpu")
    with pytest.raises(fleet.ReceiverBudgetError, match="over budget"):
        fleet.lower_receiver_schedule(
            faults.AdversarySchedule(n=40), SETTINGS.with_(
                receiver_capacity_cap=32), fleet_size=8, device="cpu")
    members = _members()
    other = fleet.lower_receiver_schedule(faults.AdversarySchedule(n=24),
                                          SETTINGS, device="cpu")
    with pytest.raises(ValueError, match="one capacity"):
        fleet.stack_receiver_members([members[0], other])
    with pytest.raises(ValueError, match="below the fleet max"):
        fleet.stack_receiver_members(members, n_delay_rules=0)
    with pytest.raises(ValueError, match="cannot shrink"):
        fleet.pad_delay_rules(members[3].faults, 0)
    stacked = fleet.stack_receiver_members(members[:2])
    with pytest.raises(ValueError, match="'fleet' axis"):
        fleet.receiver_fleet_simulate(
            stacked, 4, SETTINGS, fleet_mesh=sharding.slot_mesh(
                2, device="cpu"), device="cpu")
    assert receiver.lower_receiver_schedule is fleet.lower_receiver_schedule
