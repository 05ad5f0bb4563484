"""The per-receiver engine's three carry layouts against the reference.

``rx_kernel`` picks the carry between ticks: "xla" (the default) the
dense ``ReceiverState``, "packed" and "pallas" the packed one. The
scenario is ``faults.crash_window_delay_schedule`` (crashes, a two-way
partition window and a jittered delay rule) at N=64 over 160 ticks and at
N=256 over 120 ticks: the port's runs under all three layouts equal the
reference's "xla" run in every ``ReceiverStepLog`` field and in every
field of the final dense state. The one difference between layouts, the
packed carry's epoch deltas, shows on a boot whose epochs lie 128 apart:
the flag under "packed" only, in both packages alike. A dense fleet of
four members at C=32 equals the reference's ``receiver_fleet_simulate``.
Lowering gives a dense member under "xla"; ``check_receiver_budget``'s
figures equal the reference's; ``link_blocked_matrix`` equals the
reference's and packs to ``link_blocked_packed``. Tolerance: exact.
"""
import numpy as np
import pytest
import torch

from rapid_tpu import faults as ref_faults
from rapid_tpu.engine import fleet as ref_fleet
from rapid_tpu.engine import monitor as ref_monitor
from rapid_tpu.engine import receiver as ref_rx
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import faults
from rapid_tpu_torch.convert import to_numpy
from rapid_tpu_torch.engine import fleet, monitor, receiver, rx_packed
from rapid_tpu_torch.engine.state import ReceiverState
from rapid_tpu_torch.settings import Settings

LAYOUTS = ("xla", "packed", "pallas")


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _assert_same(port_nt, ref_nt, what):
    port_np = to_numpy(port_nt)
    for name in ref_nt._fields:
        want = np.asarray(getattr(ref_nt, name))
        got = np.asarray(getattr(port_np, name))
        assert got.dtype == want.dtype and got.shape == want.shape, \
            f"{what}.{name}"
        assert np.array_equal(got, want), f"{what}.{name}"


def _ref_schedule(sched):
    return ref_faults.AdversarySchedule(
        n=sched.n, crashes=sched.crashes,
        windows=tuple(ref_faults.LinkWindow(**vars(w))
                      for w in sched.windows),
        delays=tuple(ref_faults.DelayRule(**vars(r)) for r in sched.delays),
        seed=sched.seed)


@pytest.fixture(scope="module", params=[(64, 160), (256, 120)],
                ids=["n64", "n256"])
def reference_run(request):
    n, ticks = request.param
    sched = faults.crash_window_delay_schedule(n)
    settings = RefSettings()
    member = ref_fleet.lower_receiver_schedule(_ref_schedule(sched),
                                               settings)
    final, logs = ref_rx.receiver_simulate(member.state, member.faults,
                                           ticks, settings)
    return sched, ticks, final, logs


@pytest.mark.parametrize("layout", LAYOUTS)
def test_every_layout_equals_the_reference_dense_run(reference_run,
                                                     layout):
    sched, ticks, want_final, want_logs = reference_run
    settings = Settings(rx_kernel=layout)
    member = receiver.lower_receiver_schedule(sched, settings, device="cpu")
    assert isinstance(member.state, ReceiverState) == (layout == "xla")
    final, logs = receiver.receiver_simulate(member.state, member.faults,
                                             ticks, settings)
    assert isinstance(final, ReceiverState)
    _assert_same(logs, want_logs, "logs")
    _assert_same(final, want_final, "final")
    receiver.check_flags(final.flags)
    assert int(logs.decide.sum()) > 0


def test_default_settings_run_the_dense_carry():
    settings = Settings()
    assert settings.rx_kernel == "xla"
    member = receiver.lower_receiver_schedule(
        faults.crash_window_delay_schedule(16), settings, device="cpu")
    final, logs = receiver.receiver_simulate(member.state, member.faults,
                                             20, settings)
    assert isinstance(final, ReceiverState)
    assert logs.tick.tolist() == list(range(1, 21))
    step_final, _ = receiver.receiver_step(member.state, member.faults,
                                           settings)
    assert int(step_final.tick) == 1


def test_layout_mismatch_is_refused_not_converted():
    sched = faults.crash_window_delay_schedule(16)
    packed = receiver.lower_receiver_schedule(
        sched, Settings(rx_kernel="packed"), device="cpu")
    with pytest.raises(TypeError, match="rx_kernel='xla'.*PackedReceiver"):
        receiver.receiver_simulate(packed.state, packed.faults, 2,
                                   Settings())
    dense = receiver.lower_receiver_schedule(sched, Settings(), device="cpu")
    stacked = fleet.stack_receiver_members([dense, dense])
    with pytest.raises(TypeError, match="packed carry.*ReceiverState"):
        fleet.receiver_fleet_simulate(stacked, 2, Settings(
            rx_kernel="pallas"), device="cpu")
    with pytest.raises(ValueError, match="one carry layout"):
        fleet.stack_receiver_members([dense, packed])


@pytest.mark.parametrize("layout", ["xla", "packed"])
def test_epoch_delta_saturation_shows_under_packed_only(layout):
    """The reference's saturation case (an epoch 128 above the minimum,
    one past the int8 delta's ceiling) run 12 ticks from the boot: the
    packed carry clamps and flags, the dense one carries it as it is;
    each package equals the other under each layout."""
    weights = dict.fromkeys(ref_faults.SCENARIO_KINDS, 0.0)
    weights["partition"] = 1.0
    ref_sched = ref_faults.sample_adversary_schedule(
        12, 0, 80, ref_faults.ScenarioWeights(**weights)).schedule
    sched = faults.sample_adversary_schedule(
        12, 0, 80, faults.ScenarioWeights(**weights)).schedule
    ref_settings = RefSettings(rx_kernel=layout)
    settings = Settings(rx_kernel=layout)

    ref_member = ref_fleet.lower_receiver_schedule(ref_sched, RefSettings())
    ref_state = ref_member.state._replace(
        epoch=ref_member.state.epoch.at[0].set(
            ref_member.state.epoch.min() + 128))
    want_final, want_logs = ref_rx.receiver_simulate(
        ref_state, ref_member.faults, 12, ref_settings)

    member = receiver.lower_receiver_schedule(sched, Settings(),
                                              device="cpu")
    state = member.state._replace(epoch=member.state.epoch.clone())
    state.epoch[0] = state.epoch.min() + 128
    final, logs = receiver.receiver_simulate(state, member.faults, 12,
                                             settings)
    _assert_same(logs, want_logs, "logs")
    _assert_same(final, want_final, "final")
    flagged = int(final.flags) & receiver.FLAG_EPOCH_DELTA_SAT
    assert bool(flagged) == (layout == "packed")
    assert int(np.asarray(want_final.flags)) == int(final.flags)


def _fleet_schedules(pkg, n=32, ticks=60):
    only = lambda *kinds: pkg.ScenarioWeights(
        **{k: (1.0 if k in kinds else 0.0) for k in pkg.SCENARIO_KINDS})
    out = [pkg.sample_adversary_schedule(
        n, s, ticks, only("partition", "flip_flop")).schedule
        for s in (2, 5)]
    out += [pkg.sample_adversary_schedule(
        n, s, ticks, only("delay", "jitter"), ring_depth=4).schedule
        for s in (4, 7)]
    return out


def test_dense_fleet_equals_the_reference():
    ticks = 60
    ref_settings = RefSettings()
    want_finals, want_logs = ref_fleet.receiver_fleet_simulate(
        ref_fleet.stack_receiver_members(
            [ref_fleet.lower_receiver_schedule(s, ref_settings)
             for s in _fleet_schedules(ref_faults)]), ticks, ref_settings)
    settings = Settings()
    members = [fleet.lower_receiver_schedule(s, settings, fleet_size=4,
                                             device="cpu")
               for s in _fleet_schedules(faults)]
    stacked = fleet.stack_receiver_members(members)
    assert isinstance(stacked.state, ReceiverState)
    assert stacked.state.member.shape == (4, 32, 32)
    finals, logs = fleet.receiver_fleet_simulate(stacked, ticks, settings,
                                                 device="cpu")
    assert isinstance(finals, ReceiverState)
    assert receiver.receiver_final_view(finals) is finals
    _assert_same(logs, want_logs, "logs")
    _assert_same(finals, want_finals, "finals")
    one, one_logs = receiver.receiver_simulate(
        fleet.member_of(stacked.state, 2), fleet.member_of(stacked.faults, 2),
        ticks, settings)
    for got, want in zip(fleet.member_of(logs, 2), one_logs):
        assert torch.equal(got, want)


def test_lowering_gives_the_reference_dense_member():
    sched = faults.crash_window_delay_schedule(24)
    member = fleet.lower_receiver_schedule(sched, Settings(), device="cpu")
    want = ref_fleet.lower_receiver_schedule(_ref_schedule(sched),
                                             RefSettings())
    assert isinstance(member.state, ReceiverState)
    _assert_same(member.state, want.state, "state")
    again = fleet.lower_receiver_schedule(
        faults.crash_window_delay_schedule(24, seed=3), Settings(),
        device="cpu")
    assert not torch.equal(again.state.delay_table, member.state.delay_table)
    assert again.state.member is member.state.member  # one boot per shape


@pytest.mark.parametrize("capacity", [1040, 4112])
@pytest.mark.parametrize("rx_kernel", LAYOUTS)
def test_member_bytes_equal_the_reference(capacity, rx_kernel):
    settings = Settings(rx_kernel=rx_kernel, receiver_capacity_cap=8192)
    ref_settings = RefSettings(rx_kernel=rx_kernel,
                               receiver_capacity_cap=8192)
    got = fleet.check_receiver_budget(capacity, 4, settings)
    want = ref_fleet.check_receiver_budget(capacity, 4, ref_settings)
    assert got == want
    dense, bundle = fleet._state_bytes(capacity, settings)
    assert got == (dense if rx_kernel == "xla" else bundle)


@pytest.mark.parametrize("n", [13, 64])
def test_link_blocked_matrix_equals_the_reference(n):
    rng = np.random.default_rng(n)
    windows = tuple(faults.LinkWindow(
        src_slots=frozenset(rng.choice(n, 5, replace=False).tolist()),
        dst_slots=frozenset(rng.choice(n, 9, replace=False).tolist()),
        start_tick=3 * w, period_ticks=w, two_way=bool(w % 2))
        for w in range(3))
    ref_windows = tuple(ref_faults.LinkWindow(**vars(w)) for w in windows)
    from rapid_tpu.engine.state import link_faults as ref_link_faults
    from rapid_tpu_torch.engine.state import link_faults

    crash = [faults.NEVER_TICK] * n
    want_faults = ref_link_faults(crash, ref_windows, n)
    got_faults = link_faults(crash, windows, n, device="cpu")
    for tick in (0, 4, 7, 12):
        want = np.asarray(ref_monitor.link_blocked_matrix(
            np, want_faults, tick))
        got = monitor.link_blocked_matrix(got_faults, tick)
        assert np.array_equal(got.numpy(), want), tick
        assert torch.equal(rx_packed.pack_bits(got),
                           monitor.link_blocked_packed(got_faults, tick))
    assert not monitor.link_blocked_matrix(
        link_faults(crash, (), n, device="cpu"), 5).any()
