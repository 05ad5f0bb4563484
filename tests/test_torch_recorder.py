"""The port's flight recorder against the JAX reference.

``recorder.init`` (and its refusal of W=0), the one-tick folds
``record_step``/``record_receiver_step`` fed the reference's own logs, the
whole-run folds ``record_run``/``record_receiver_run``, and the recorders
that ``step.simulate`` and ``receiver.receiver_simulate`` return: ring
rows, count and stamps equal the reference's for shared runs (a crash
burst with the window wrapping around, a contested run filling part of
it, the ring variant with the invariant monitor on) and packed receiver
runs; the final state and logs equal the runs without the recorder; with
W=0 nothing in the recorder is called. Tolerance: exact.
"""
import importlib
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_tpu.engine import fleet as ref_fleet
from rapid_tpu.engine import paxos as ref_paxos
from rapid_tpu.engine import recorder as ref_recorder
from rapid_tpu.engine.state import crash_faults as ref_crash_faults
from rapid_tpu.engine.state import init_state as ref_init_state
from rapid_tpu.faults import AdversarySchedule as RefSchedule
from rapid_tpu.faults import LinkWindow as RefWindow
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch.convert import from_reference, to_numpy
from rapid_tpu_torch.engine import receiver, recorder, step
from rapid_tpu_torch.engine.state import I32_MAX
from rapid_tpu_torch.faults import AdversarySchedule, LinkWindow
from rapid_tpu_torch.identity import synthetic_uids
from rapid_tpu_torch.settings import Settings

ref_step = importlib.import_module("rapid_tpu.engine.step")
ref_rx = importlib.import_module("rapid_tpu.engine.receiver")
OFF = RefSettings(seed=9101)


def _port_settings(settings):
    return Settings(**{f: getattr(settings, f) for f in (
        "seed", "capacity", "rx_kernel", "protocol_variant",
        "invariant_checks", "flight_recorder_window")})


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


def _same_recorder(port_rec, ref_rec):
    _assert_same(port_rec, ref_rec)
    assert np.array_equal(recorder.ring_rows(port_rec),
                          np.asarray(ref_recorder.ring_rows(ref_rec)))
    assert recorder.stamps(port_rec) == ref_recorder.stamps(ref_rec)
    assert recorder.recorder_payload(port_rec) == \
        ref_recorder.recorder_payload(ref_rec)


def test_init_equals_the_reference_and_refuses_w0():
    with pytest.raises(ValueError, match="flight_recorder_window=0"):
        recorder.init(Settings(), device="cpu")
    on = replace(OFF, flight_recorder_window=8)
    _assert_same(recorder.init(_port_settings(on), device="cpu"),
                 ref_recorder.init(on))
    assert recorder.GAUGE_NAMES == ref_recorder.GAUGE_NAMES
    assert recorder.UNOBSERVED == ref_recorder.UNOBSERVED


def test_from_reference_carries_a_recorder():
    rec = ref_recorder.init(replace(OFF, flight_recorder_window=4))
    port = from_reference(rec, device="cpu")
    assert isinstance(port, recorder.RecorderState)
    assert port.ring.dtype == torch.int32
    _assert_same(port, rec)


# ---------------------------------------------------------------------------
# shared runs
# ---------------------------------------------------------------------------


def _crash_run(n=64):
    state = ref_init_state(synthetic_uids(n), 0, OFF)
    ticks = [I32_MAX] * n
    for slot in range(8):
        ticks[slot] = 5
    return state, ref_crash_faults(ticks), None, 130


def _contested_run(n=64):
    uids = synthetic_uids(n)
    sched, _ = ref_paxos.synthetic_contested_schedule(n, OFF, 48, uids=uids)
    return (ref_init_state(uids, 0, OFF), ref_crash_faults([I32_MAX] * n),
            sched, 48)


# name: (boot, settings changes)
SHARED = {
    "crash_w8_wraps": (_crash_run, dict(flight_recorder_window=8)),
    "contested_w64_partial": (_contested_run,
                              dict(flight_recorder_window=64)),
    "crash_ring_monitor_w16": (_crash_run, dict(
        flight_recorder_window=16, protocol_variant="ring",
        invariant_checks=True)),
}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_recorder_equals_the_reference(name):
    make, changes = SHARED[name]
    state, faults, sched, ticks = make()
    on = replace(OFF, **changes)
    want_final, want_logs, want_rec = ref_step.simulate(
        state, faults, ticks, on, fallback=sched)
    port_args = (from_reference(state, device="cpu"),
                 from_reference(faults, device="cpu"), ticks)
    fallback = None if sched is None else from_reference(sched,
                                                         device="cpu")
    final, logs, rec = step.simulate(*port_args, _port_settings(on),
                                     fallback=fallback, device="cpu")
    _same_recorder(rec, want_rec)
    _assert_same(logs, want_logs)
    _assert_same(final, want_final)
    # The recorder changes nothing else: the run without it is the same.
    off = _port_settings(replace(on, flight_recorder_window=0))
    final_off, logs_off = step.simulate(*port_args, off, fallback=fallback,
                                        device="cpu")
    for a, b in ((final, final_off), (logs, logs_off)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert int(rec.first_decide) > 0


def test_one_tick_folds_equal_the_reference_and_the_run_fold():
    """``record_step`` fed the reference's logs tick by tick equals the
    reference's ``record_step``, and both equal ``record_run`` once over
    the stacked logs, through a wrap-around."""
    state, faults, _, _ = _crash_run()
    on = replace(OFF, flight_recorder_window=8)
    _, logs = ref_step.simulate(state, faults, 120, OFF)
    port_logs = from_reference(logs, device="cpu")
    want = ref_recorder.init(on)
    got = recorder.init(_port_settings(on), device="cpu")
    for i in range(100, 120):
        tick_log = type(logs)(*[jnp.asarray(f)[i] for f in logs])
        want = ref_recorder.record_step(want, tick_log, on)
        got = recorder.record_step(
            got, type(port_logs)(*[f[i] for f in port_logs]),
            _port_settings(on))
    _same_recorder(got, want)
    tail = type(port_logs)(*[f[100:120] for f in port_logs])
    _same_recorder(recorder.record_run(
        recorder.init(_port_settings(on), device="cpu"), tail,
        _port_settings(on)), want)


# ---------------------------------------------------------------------------
# packed receiver runs
# ---------------------------------------------------------------------------


def _rx_schedules(name):
    if name == "n12_window_w6":
        kw = dict(n=12, seed=9, crashes=((0, 4),))
        window = dict(src_slots=frozenset(range(0, 4)),
                      dst_slots=frozenset(range(4, 12)), start_tick=2,
                      end_tick=9)
        return (RefSchedule(**kw, windows=(RefWindow(**window),)),
                AdversarySchedule(**kw, windows=(LinkWindow(**window),)),
                6, 25)
    kw = dict(n=16, seed=3, crashes=((2, 5), (9, 5)))
    return RefSchedule(**kw), AdversarySchedule(**kw), 64, 130


@pytest.mark.parametrize("name", ["n12_window_w6", "n16_crash_w64"])
def test_receiver_recorder_equals_the_reference(name):
    ref_sched, port_sched, w, ticks = _rx_schedules(name)
    on = RefSettings(rx_kernel="pallas", capacity=ref_sched.n, seed=9106,
                     flight_recorder_window=w)
    member = ref_fleet.lower_receiver_schedule(ref_sched, on)
    _, want_logs, want_rec = ref_rx.receiver_simulate(
        member.state, member.faults, ticks, on)
    port_on = _port_settings(on)
    m = receiver.lower_receiver_schedule(port_sched, port_on, device="cpu")
    final, logs, rec = receiver.receiver_simulate(m.state, m.faults, ticks,
                                                  port_on)
    _same_recorder(rec, want_rec)
    _assert_same(logs, want_logs)
    off = _port_settings(replace(on, flight_recorder_window=0))
    final_off, logs_off = receiver.receiver_simulate(m.state, m.faults,
                                                     ticks, off)
    for a, b in ((final, final_off), (logs, logs_off)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # One row per tick folded into the receiver's gauges.
    for i in range(min(w, ticks)):
        tick_log = type(want_logs)(*[jnp.asarray(f)[ticks - 1 - i]
                                     for f in want_logs])
        assert int(tick_log.tick) == int(recorder.ring_rows(rec)[-1 - i, 0])


def test_receiver_one_tick_fold_equals_the_reference():
    ref_sched, port_sched, _, _ = _rx_schedules("n12_window_w6")
    on = RefSettings(rx_kernel="pallas", capacity=12, seed=9107,
                     flight_recorder_window=4)
    member = ref_fleet.lower_receiver_schedule(ref_sched, on)
    _, logs = ref_rx.receiver_simulate(
        member.state, member.faults, 10,
        replace(on, flight_recorder_window=0))[:2]
    port_logs = from_reference(logs, device="cpu")
    want = ref_recorder.init(on)
    got = recorder.init(_port_settings(on), device="cpu")
    for i in range(10):
        want = ref_recorder.record_receiver_step(
            want, type(logs)(*[jnp.asarray(f)[i] for f in logs]), on)
        got = recorder.record_receiver_step(
            got, type(port_logs)(*[f[i] for f in port_logs]),
            _port_settings(on))
    _same_recorder(got, want)


# ---------------------------------------------------------------------------
# W = 0: the recorder is never entered
# ---------------------------------------------------------------------------


def test_w0_never_calls_the_recorder(monkeypatch):
    def spy(*args, **kwargs):
        raise AssertionError("the recorder was called with W=0")

    for name in ("init", "record_run", "record_receiver_run",
                 "record_step", "record_receiver_step"):
        monkeypatch.setattr(recorder, name, spy)
    state, faults, _, _ = _crash_run(16)
    got = step.simulate(from_reference(state, device="cpu"),
                        from_reference(faults, device="cpu"), 8,
                        Settings(), device="cpu")
    assert len(got) == 2
    _, port_sched, _, _ = _rx_schedules("n12_window_w6")
    settings = Settings(rx_kernel="pallas", capacity=12)
    m = receiver.lower_receiver_schedule(port_sched, settings, device="cpu")
    assert len(receiver.receiver_simulate(m.state, m.faults, 4,
                                          settings)) == 2
