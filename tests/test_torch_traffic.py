"""The port's traffic generator and load servo against the reference's.

Both generators draw one PCG64 stream per tick, so the same config gives
the same schedules and counts chunk for chunk; the chunk split changes
nothing; ``state_dict`` resumes exactly, across the packages too; an
oversize window is refused with the reference's message; and the servo
follows the reference's control law step for step.
"""
import numpy as np
import pytest

from rapid_tpu import service as ref_service
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch.convert import servo_from_reference, traffic_from_reference
from rapid_tpu_torch.engine.churn import ChurnSchedule
from rapid_tpu_torch.service import (LoadServo, ServoConfig, TrafficConfig,
                                     TrafficGenerator)
from rapid_tpu_torch.settings import Settings

#: ``(TrafficConfig kwargs, capacity, n_initial, chunk)`` cases: the
#: soak's, a diurnal swing without slot reuse, closed-loop sampling, and
#: heavy leave bursts against the member floor.
CASES = {
    "soak": (dict(seed=0, join_rate_per_ktick=20.0,
                  leave_burst_rate_per_ktick=2.0, leave_burst_size=4,
                  diurnal_amplitude=0.3, diurnal_period_ticks=4096),
             96, 24, 512),
    "diurnal_no_reuse": (dict(seed=11, join_rate_per_ktick=50.0,
                              diurnal_amplitude=0.8,
                              diurnal_period_ticks=300, reuse_slots=False),
                         24, 8, 105),
    "closed_loop": (dict(seed=3, join_rate_per_ktick=120.0,
                         leave_burst_rate_per_ktick=6.0, closed_loop=True),
                    64, 16, 64),
    "bursty_floor": (dict(seed=5, join_rate_per_ktick=5.0,
                          leave_burst_rate_per_ktick=40.0,
                          leave_burst_size=9, min_members=10,
                          max_join_burst=3), 48, 20, 128),
}


def _pair(name):
    kw, capacity, n, chunk = CASES[name]
    settings = Settings(stream_chunk_ticks=max(chunk, 256))
    ref_settings = RefSettings(stream_chunk_ticks=max(chunk, 256))
    return (TrafficGenerator(TrafficConfig(**kw), settings, capacity, n),
            ref_service.TrafficGenerator(ref_service.TrafficConfig(**kw),
                                         ref_settings, capacity, n),
            settings, chunk)


def _same_schedule(got, want):
    if want is None:
        assert got is None
        return
    assert isinstance(got, ChurnSchedule)
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if b is None:
            assert a is None, field
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("name", sorted(CASES))
def test_generator_equals_reference_chunk_for_chunk(name):
    gen, ref, _, chunk = _pair(name)
    assert np.array_equal(gen.boot_id_fps(), ref.boot_id_fps())
    for _ in range(12):
        got, got_info = gen.next_chunk(chunk)
        want, want_info = ref.next_chunk(chunk)
        assert got_info == want_info
        _same_schedule(got, want)
    assert gen.state_dict() == ref.state_dict()
    assert (gen.events, gen.joins, gen.leaves, gen.bursts) == \
        (ref.events, ref.joins, ref.leaves, ref.bursts)


def test_chunk_split_does_not_change_the_traffic():
    gen_one, _, settings, _ = _pair("diurnal_no_reuse")
    gen_four, _, _, _ = _pair("diurnal_no_reuse")
    gen_one.next_chunk(420)
    for _ in range(4):
        gen_four.next_chunk(105)
    assert gen_one.state_dict() == gen_four.state_dict()
    assert gen_one.churn_calls(settings) == gen_four.churn_calls(settings)


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_dict_resumes_exactly_across_the_packages(name):
    """A generator resumed from a snapshot (its own, or the reference's
    carried by ``convert.traffic_from_reference``) draws on as the
    uninterrupted one does."""
    gen, ref, settings, chunk = _pair(name)
    for _ in range(3):
        gen.next_chunk(chunk)
        ref.next_chunk(chunk)
    own = TrafficGenerator.from_state(gen.state_dict(), settings)
    crossed = traffic_from_reference(ref, settings)
    for _ in range(3):
        want, want_info = gen.next_chunk(chunk)
        for other in (own, crossed):
            got, got_info = other.next_chunk(chunk)
            assert got_info == want_info
            _same_schedule(got, want)
    assert own.state_dict() == gen.state_dict() == crossed.state_dict()


def test_oversize_window_and_bad_configs_raise_as_the_reference():
    kw, capacity, n, _ = CASES["soak"]
    settings = Settings(stream_chunk_ticks=16)
    ref_settings = RefSettings(stream_chunk_ticks=16)
    messages = []
    for mod, s in ((None, settings), (ref_service, ref_settings)):
        cfg = (TrafficConfig if mod is None else mod.TrafficConfig)(
            **dict(kw, join_rate_per_ktick=900.0,
                   leave_burst_rate_per_ktick=300.0))
        gen = (TrafficGenerator if mod is None else mod.TrafficGenerator)(
            cfg, s, capacity, n)
        with pytest.raises(ValueError) as exc:
            for _ in range(20):
                gen.next_chunk(4000)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
    assert "slot-recycle delay" in messages[0]
    for bad in (dict(join_rate_per_ktick=-1.0), dict(diurnal_amplitude=2.0),
                dict(diurnal_period_ticks=0), dict(leave_burst_size=0)):
        with pytest.raises(ValueError) as got:
            TrafficConfig(**bad)
        with pytest.raises(ValueError) as want:
            ref_service.TrafficConfig(**bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        TrafficGenerator(TrafficConfig(), settings, 8, 8)
    with pytest.raises(ValueError) as want:
        ref_service.TrafficGenerator(ref_service.TrafficConfig(),
                                     ref_settings, 8, 8)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="closed_loop"):
        TrafficGenerator(TrafficConfig(), settings, 16, 8).set_join_rate(5.0)


@pytest.mark.parametrize("pinned", [None, 800.0])
def test_servo_follows_the_reference_control_law(pinned):
    """Observations of committed walls (some below the measurable floor)
    move the port's servo exactly as the reference's, and its state
    crosses ``convert.servo_from_reference``."""
    kw = dict(target_events_per_sec=40.0, pinned_ticks_per_sec=pinned,
              gain=0.25)
    servo = LoadServo(ServoConfig(**kw))
    ref = ref_service.LoadServo(ref_service.ServoConfig(**kw))
    walls = [0.5, 0.25, 0.0004, 1.7, 0.9, 0.31, 2.2, 0.0]
    for i, wall in enumerate(walls):
        for s in (servo, ref):
            s.observe(ticks=512, wall_s=wall, backlog=3 * i)
        assert servo.chunk_block(servo.rate_per_ktick) == \
            ref.chunk_block(ref.rate_per_ktick)
        assert servo.state_dict() == ref.state_dict()
    crossed = servo_from_reference(ref)
    assert crossed.state_dict() == servo.state_dict()
    if pinned is not None:
        assert servo.updates == 0
        assert servo.rate_per_ktick == 1000.0 * 40.0 / pinned


def test_servo_config_refusals_match_the_reference():
    for bad in (dict(target_events_per_sec=0.0),
                dict(target_events_per_sec=1.0, gain=0.0),
                dict(target_events_per_sec=1.0, tps_quantum=0.0),
                dict(target_events_per_sec=1.0, min_rate_per_ktick=5.0,
                     max_rate_per_ktick=5.0),
                dict(target_events_per_sec=1.0, pinned_ticks_per_sec=-1.0)):
        with pytest.raises(ValueError) as got:
            ServoConfig(**bad)
        with pytest.raises(ValueError) as want:
            ref_service.ServoConfig(**bad)
        assert str(got.value) == str(want.value)
