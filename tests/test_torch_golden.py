"""The committed golden run of the port against the JAX reference.

``rapid_tpu_torch/testdata/rx_n64_golden.json`` holds the reference's
counters, phase counters, events and config ids on the N=64, 160-tick
crash + partition + delay scenario; ``chip_smoke.py`` holds the card to
it. Here the file is regenerated from the reference and must be
unchanged, and the port's CPU run must equal it. Regenerate with
``JAX_PLATFORMS=cpu python tests/test_torch_golden.py``.
"""
import numpy as np
import pytest

from rapid_tpu.engine import fleet as fleet_mod
from rapid_tpu.engine import receiver as ref_rx
from rapid_tpu.faults import AdversarySchedule, DelayRule, LinkWindow
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import golden
from rapid_tpu_torch.engine import receiver as port_rx
from rapid_tpu_torch.faults import crash_window_delay_schedule
from rapid_tpu_torch.settings import Settings


def reference_schedule(port_schedule):
    """The reference's ``AdversarySchedule`` with the port's fields."""
    return AdversarySchedule(
        n=port_schedule.n, crashes=port_schedule.crashes,
        windows=tuple(LinkWindow(**vars(w)) for w in port_schedule.windows),
        delays=tuple(DelayRule(**vars(r)) for r in port_schedule.delays),
        seed=port_schedule.seed)


def reference_record(n: int, ticks: int) -> dict:
    settings = RefSettings(rx_kernel="pallas")
    sched = reference_schedule(crash_window_delay_schedule(n))
    member = fleet_mod.lower_receiver_schedule(sched, settings)
    final, logs = ref_rx.receiver_simulate(member.state, member.faults,
                                           ticks, settings)
    ref_rx.check_flags(int(np.asarray(final.flags)))
    return golden.record(ref_rx.receiver_events(logs),
                         ref_rx.receiver_counters(logs),
                         ref_rx.receiver_phase_counters(logs),
                         ref_rx.receiver_config_ids(final), n)


@pytest.fixture(scope="module")
def reference():
    return reference_record(golden.GOLDEN_N, golden.GOLDEN_TICKS)


def test_golden_file_matches_reference(reference):
    assert golden.dumps(reference) == golden.GOLDEN_PATH.read_text()


def test_golden_scenario_decides(reference):
    n = golden.GOLDEN_N
    kinds = {e[1] for slot in reference["events"] for e in slot}
    assert kinds == {"proposal", "view_change"}
    assert sum(row["fast_vote_sent"] for row in reference["phase_counters"])
    assert len(set(reference["config_ids"][:n])) > 1  # crashed slots lag


def test_port_cpu_run_equals_golden():
    settings = Settings(rx_kernel="pallas")
    member = port_rx.lower_receiver_schedule(
        crash_window_delay_schedule(golden.GOLDEN_N), settings, device="cpu")
    final, logs = port_rx.receiver_simulate(member.state, member.faults,
                                            golden.GOLDEN_TICKS, settings)
    port_rx.check_flags(final.flags)
    got = golden.run_record(final, logs, golden.GOLDEN_N)
    assert golden.differences(got, golden.load()) == []


if __name__ == "__main__":
    golden.GOLDEN_PATH.write_text(golden.dumps(
        reference_record(golden.GOLDEN_N, golden.GOLDEN_TICKS)))
    print("wrote", golden.GOLDEN_PATH)
