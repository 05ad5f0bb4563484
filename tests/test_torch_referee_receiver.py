"""The port's ``run_receiver_differential`` against the reference's: the
per-receiver engine (``device="cpu"``, the plain delivery) against the
host adversary engine, on the N <= 64 delay, partition and slow-link
scenarios of ``tests/test_delay.py`` (its two N=256 ones marked slow, as
the reference's are) and on ``chip_smoke.py``'s delay scenario, the
first divergence of phase 4's scenario from the referee (at N=64, and at
N=1024 marked slow), and the envelope errors it raises
(``ReceiverEnvelopeError`` on a cross-phase reorder, ``DelayBudgetError``,
scripted proposes refused) with the reference's messages. The reference
runs its dense carry (``rx_kernel="xla"``); the port runs the dense
carry or the packed one, whose final state comes back dense to the same
``receiver_run_payload``. Everything is integer: the tolerance is exact.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from rapid_tpu import faults as ref_faults
from rapid_tpu.engine import diff as ref_diff
from rapid_tpu.engine import receiver as ref_receiver
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import convert
from rapid_tpu_torch import faults
from rapid_tpu_torch.engine import diff
from rapid_tpu_torch.engine.receiver import ReceiverEnvelopeError
from rapid_tpu_torch.settings import Settings
from test_torch_referee import (ADVERSARIAL, DR, _crash_delay, _same,
                                _same_error, _scripted, _slow_voters,
                                two_way_split)

RING = Settings().delivery_ring_depth


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# run_receiver_differential: the per-receiver engine against the referee
# ---------------------------------------------------------------------------

RECEIVER = {
    "delay_only_n64": (ADVERSARIAL["delay_only_n64"][0], 200, None, "xla"),
    "delay_partition_n64": (ref_faults.AdversarySchedule(
        n=64, seed=17,
        windows=(ref_faults.LinkWindow(src_slots=frozenset(range(52)),
                                       dst_slots=frozenset(range(52, 64)),
                                       start_tick=6),),
        delays=(DR(src_slots=frozenset(range(10)),
                   dst_slots=frozenset(range(10, 40)), delay_ticks=2,
                   jitter_ticks=1),)), 240, None, "xla"),
    "jitter_reorder_n64": (_crash_delay(64, [DR(
        src_slots=frozenset(range(8)), dst_slots=frozenset(range(8, 64)),
        delay_ticks=0, jitter_ticks=2, reverse_delay_ticks=1)], seed=23),
        200, None, "packed"),
    "delay_zero_n16": (_crash_delay(16, [DR(
        src_slots=frozenset(range(6)), dst_slots=frozenset(range(6, 16)),
        delay_ticks=0)]), 160, None, "xla"),
    "ring_horizon_n16": (_crash_delay(16, [DR(
        src_slots=frozenset(range(5)), dst_slots=frozenset(range(5, 16)),
        delay_ticks=RING - 1)]), 200, None, "packed"),
    "ring_depth_one_n16": (_crash_delay(16, []), 160, 1, "xla"),
    "slow_link_n64": (_slow_voters(64, 16, 40), 400, 48, "xla"),
    # chip_smoke.py's half_delay_schedule, phase 23's exact delay scenario
    "half_delay_n64": (_crash_delay(64, [DR(
        src_slots=frozenset(range(32)), dst_slots=frozenset(range(64)),
        delay_ticks=2, jitter_ticks=1)], seed=41), 200, None, "xla"),
}
SLOW_RECEIVER = {
    "delay_family_n256": (_crash_delay(256, [DR(
        src_slots=frozenset(range(30)), dst_slots=frozenset(range(30, 256)),
        delay_ticks=2, jitter_ticks=1)], seed=41), 200, None, "xla"),
    "slow_link_n256": (_slow_voters(256, 64, 80), 400, 96, "xla"),
}


def _receiver_settings(ring, rx_kernel):
    port, ref = Settings(rx_kernel=rx_kernel), RefSettings()
    if ring is not None:
        port = port.with_(delivery_ring_depth=ring)
        ref = ref.with_(delivery_ring_depth=ring)
    return port, ref


@pytest.mark.parametrize("name", sorted(RECEIVER) + [
    pytest.param(name, marks=pytest.mark.slow) for name in SLOW_RECEIVER])
def test_receiver_differential_equals_reference(name):
    ref_sched, ticks, ring, rx_kernel = {**RECEIVER, **SLOW_RECEIVER}[name]
    port_settings, ref_settings = _receiver_settings(ring, rx_kernel)
    port = diff.run_receiver_differential(
        convert.schedule_from_reference(ref_sched), ticks, port_settings,
        device="cpu")
    _same(port, ref_diff.run_receiver_differential(ref_sched, ticks,
                                                   ref_settings))
    assert set(port.seconds) == {"referee", "engine"}
    if name.startswith("delay_family"):
        _same(diff.run_adversarial_differential(
            convert.schedule_from_reference(ref_sched), ticks,
            port_settings), ref_diff.run_adversarial_differential(
                ref_sched, ticks, ref_settings))
    if name.startswith("slow_link"):
        for phase in ("phase1a_sent", "phase1b_sent", "phase2a_sent",
                      "phase2b_sent"):
            assert sum(d[phase] for d in port.engine_phase_counters) > 0


def test_receiver_envelope_errors_equal_reference():
    cross = _slow_voters(64, 16, 30)
    port_settings, ref_settings = _receiver_settings(32, "xla")
    _same_error(ReceiverEnvelopeError, ref_receiver.ReceiverEnvelopeError,
                lambda: diff.run_receiver_differential(
                    convert.schedule_from_reference(cross), 400,
                    port_settings, device="cpu"),
                lambda: ref_diff.run_receiver_differential(
                    cross, 400, ref_settings))
    over = _crash_delay(8, [DR(src_slots=frozenset({0}),
                               dst_slots=frozenset({1}), delay_ticks=RING)])
    _same_error(faults.DelayBudgetError, ref_faults.DelayBudgetError,
                lambda: diff.run_receiver_differential(
                    convert.schedule_from_reference(over), 40, Settings(),
                    device="cpu"),
                lambda: ref_diff.run_receiver_differential(
                    over, 40, RefSettings()))
    scripted = _scripted(8, *two_way_split(8))
    _same_error(ValueError, ValueError,
                lambda: diff.run_receiver_differential(
                    convert.schedule_from_reference(scripted), 40,
                    Settings(), device="cpu"),
                lambda: ref_diff.run_receiver_differential(
                    scripted, 40, RefSettings()))


def _reference_main_schedule(n):
    """The reference's form of ``faults.crash_window_delay_schedule(n)``,
    phase 4's scenario."""
    ref_sched = ref_faults.AdversarySchedule(
        n=n, crashes=((3 * n // 16, 5), (14 * n // 16, 5)), seed=11,
        windows=(ref_faults.LinkWindow(src_slots=frozenset(range(n // 8)),
                                       dst_slots=frozenset(range(n // 8, n)),
                                       start_tick=20, end_tick=60,
                                       two_way=True),),
        delays=(DR(src_slots=frozenset(range(n // 4)),
                   dst_slots=frozenset(range(n // 4, 10 * n // 16)),
                   delay_ticks=1, jitter_ticks=2, start_tick=5,
                   end_tick=150),))
    assert convert.schedule_from_reference(ref_sched) == \
        faults.crash_window_delay_schedule(n)
    return ref_sched


def test_reference_engine_divergence_is_copied():
    """On ``crash_window_delay_schedule`` the reference's per-receiver
    engine leaves exactness without a flag: three slots' alert batches,
    delayed into the tick their decide lands, make them announce first
    on the referee (192 fast votes at tick 115) and not on the engine.
    The port's runner gives the same result, divergence included."""
    ref_sched = _reference_main_schedule(64)
    port = diff.run_receiver_differential(
        convert.schedule_from_reference(ref_sched), 160, Settings(),
        device="cpu")
    ref = ref_diff.run_receiver_differential(ref_sched, 160, RefSettings())
    for res in (port, ref):
        div = res.first_divergence()
        assert (div.tick, div.field, div.engine, div.oracle) == \
            (115, "counters.sent", 0, 192)
    assert convert.plain(port) == convert.plain(ref)


@pytest.mark.slow
def test_reference_engine_divergence_at_main_width():
    """The first divergence ``chip_smoke.py`` holds phase 23's main run
    to (``MAIN_REFEREE_DIVERGENCE``, tick 112) comes from the reference
    at N=1024: its host adversary engine sends 1,046,528 messages at
    tick 112 (every survivor's fast vote), and its per-receiver engine
    653,312 (``rx_n1024_recorder.json``, which the reference wrote). The
    port's host engine gives the reference's run, field for field."""
    from rapid_tpu.engine.adversary import AdversaryEngine as RefEngine
    from rapid_tpu.oracle.membership_view import (
        id_fingerprint as ref_fingerprint, uid_of as ref_uid_of)

    from rapid_tpu_torch import golden
    from rapid_tpu_torch.engine.adversary import AdversaryEngine
    from rapid_tpu_torch.identity import id_fingerprint
    from rapid_tpu_torch.oracle.membership_view import uid_of

    n, ticks = 1024, 160
    ref_sched = _reference_main_schedule(n)
    mask = (1 << 64) - 1
    ref = RefEngine(
        ref_sched, [ref_uid_of(e) for e in ref_diff.default_endpoints(n)],
        sum(ref_fingerprint(x) for x in ref_diff.default_node_ids(n)) & mask,
        RefSettings()).run(ticks)
    port = AdversaryEngine(
        convert.schedule_from_reference(ref_sched),
        [uid_of(e) for e in diff.default_endpoints(n)],
        sum(id_fingerprint(x) for x in diff.default_node_ids(n)) & mask,
        Settings()).run(ticks)
    assert convert.plain(port) == convert.plain(ref)

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    tick, field, card, referee = chip_smoke.MAIN_REFEREE_DIVERGENCE
    assert field == "counters.sent"
    assert ref.tick_history[tick - 1]["sent"] == referee == 1046528
    assert all(ref.tick_history[t - 1] == port.tick_history[t - 1]
               for t in range(1, tick + 1))
    recorded = golden.load(golden.RX_RECORDERS[1].path)
    assert recorded["n"] == n
    assert recorded["counters"][tick - 1]["sent"] == card == 653312
    assert recorded["counters"][:tick - 1] == ref.tick_history[:tick - 1]
